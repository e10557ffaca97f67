"""Local deployment of a JobGraph as threads in one process."""

from .local import LocalJob, deploy_local, run_job  # noqa: F401
