"""The run client over the local store (`run_client.py`)."""

from .run_client import ClientError, RunClient

__all__ = ["ClientError", "RunClient"]
