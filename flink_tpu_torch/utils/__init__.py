"""Utilities of the port (``utils/auth.py``: the cluster secret of the
network endpoints)."""
