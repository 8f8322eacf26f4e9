"""Multi-stream serving: dynamic + continuous batching, HTTP facade."""

from .pool import ContinuousBatcher, PoolStream
from .server import BatchingServer, make_http_server, wav_bytes

__all__ = [
    "BatchingServer",
    "ContinuousBatcher",
    "PoolStream",
    "make_http_server",
    "wav_bytes",
]
