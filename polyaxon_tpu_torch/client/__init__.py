"""The run and project clients, over the local store or HTTP
(`run_client.py`)."""

from .run_client import ClientError, ProjectClient, RunClient

__all__ = ["ClientError", "ProjectClient", "RunClient"]
