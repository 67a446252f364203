"""The HTTP API and UI server of the live node — the port of
``sidecar_tpu/web/`` (reference: the sidecarhttp package)."""

from sidecar_tpu_torch.web.api import ApiServer, HttpListener, SidecarApi
from sidecar_tpu_torch.web.server import serve_http

__all__ = ["SidecarApi", "ApiServer", "HttpListener", "serve_http"]
