"""Utilities of the port (``utils/auth.py``: the cluster secret of the
network endpoints; ``utils/httpd.py``: the SQL gateway's HTTP server)."""
