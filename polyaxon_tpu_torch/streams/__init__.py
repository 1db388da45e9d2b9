"""The streams and control service: HTTP access to the run store (own
copies of `polyaxon_tpu/streams/`)."""

from .server import BackgroundServer, make_server, serve  # noqa: F401
