"""The HTTP metrics endpoint: Prometheus text over stdlib ``http.server``.

The port's copy of ``psana_ray_tpu/obs/exporter.py``. Every long-running
program (producer, consumer, sfx, queue server) takes ``--metrics_port``;
a non-zero port starts one :class:`MetricsServer` on a daemon thread
serving:

- ``GET /metrics``: Prometheus exposition text-format 0.0.4;
- ``GET /healthz``: the same registry as a JSON snapshot;
- ``GET /federate``: the snapshot host-tagged, the document the queue
  server's 'N' ``{"op": "metrics"}`` RPC answers.

``--metrics_port 0`` (the default) starts nothing: no socket, no thread.
:class:`MetricsServer` itself binds a free port for ``port=0``; the "0 is
off" rule lives in :func:`start_metrics_server`.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from psana_ray_tpu_torch.obs.registry import MetricsRegistry, federation_payload

logger = logging.getLogger(__name__)

CONTENT_TYPE_PROM = "text/plain; version=0.0.4; charset=utf-8"


class MetricsServer:
    """A background-thread HTTP server over one :class:`MetricsRegistry`."""

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        host: str = "0.0.0.0",
        port: int = 0,
    ):
        self.registry = registry if registry is not None else MetricsRegistry.default()
        reg = self.registry

        class _Handler(BaseHTTPRequestHandler):
            def _send(self, code: int, ctype: str, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 (http.server's name)
                path = self.path.split("?", 1)[0]
                try:
                    if path in ("/metrics", "/"):
                        self._send(200, CONTENT_TYPE_PROM, reg.render_prometheus().encode())
                    elif path in ("/healthz", "/snapshot"):
                        self._send(200, "application/json", json.dumps(reg.snapshot()).encode())
                    elif path == "/federate":
                        body = json.dumps(federation_payload(reg)).encode()
                        self._send(200, "application/json", body)
                    else:
                        self._send(404, "text/plain", b"not found\n")
                except BrokenPipeError:
                    pass  # the scraper hung up
                except Exception as e:  # noqa: BLE001 (never kill the server)
                    try:
                        self._send(500, "text/plain", repr(e).encode())
                    except OSError:
                        pass

            def log_message(self, fmt, *args):  # scrapes are periodic: debug only
                logger.debug("metrics http: " + fmt, *args)

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        kwargs={"poll_interval": 0.2}, daemon=True,
                                        name="metrics-http")

    def start(self) -> "MetricsServer":
        self._thread.start()
        logger.info("metrics endpoint up on %s:%d (/metrics, /healthz)", self.host, self.port)
        return self

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=2.0)

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc):
        self.close()


def add_metrics_args(parser) -> None:
    """``--metrics_host`` and ``--metrics_port``, the JAX package's flags."""
    parser.add_argument(
        "--metrics_host", default="0.0.0.0",
        help="interface for --metrics_port (default all interfaces; bind 127.0.0.1 on "
             "untrusted networks: the endpoint is unauthenticated)",
    )
    parser.add_argument(
        "--metrics_port", type=int, default=0,
        help="serve Prometheus metrics (counters, latency quantiles, per-stage timings, "
             "queue health) on this port; 0 = disabled (zero cost)",
    )


def start_metrics_server(
    port: int,
    registry: Optional[MetricsRegistry] = None,
    host: str = "0.0.0.0",
) -> Optional[MetricsServer]:
    """Start the endpoint on ``port``; ``port <= 0`` is off (None). A port
    that cannot be bound is logged and gives None: the data flow outranks
    its own observability."""
    if port is None or port <= 0:
        return None
    try:
        return MetricsServer(registry=registry, host=host, port=port).start()
    except OSError as e:
        logger.warning("metrics endpoint on port %d unavailable: %s", port, e)
        return None
