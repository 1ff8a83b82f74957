"""pw.io.http — HTTP streaming client + REST server connector (reference:
python/pathway/io/http/__init__.py:28 client; _server.py:624
rest_connector + :329 PathwayWebserver)."""

from pathway_tpu_torch.io.http._server import (
    EndpointDocumentation,
    PathwayWebserver,
    RestServerSubject,
    rest_connector,
)
from pathway_tpu_torch.io.http._client import (
    HttpError,
    KeepAliveSession,
    read,
    write,
)
from pathway_tpu_torch.io.http._frontend import FrontendMetrics, ServingFrontend

__all__ = [
    "PathwayWebserver",
    "EndpointDocumentation",
    "RestServerSubject",
    "rest_connector",
    "ServingFrontend",
    "FrontendMetrics",
    "KeepAliveSession",
    "HttpError",
    "read",
    "write",
]
