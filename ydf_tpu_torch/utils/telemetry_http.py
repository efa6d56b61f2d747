"""Telemetry exposition endpoints: /metrics, /healthz, /statusz
(counterpart of ydf_tpu/utils/telemetry_http.py).

A tiny stdlib `http.server` thread serving

  /metrics   Prometheus text exposition of the process registry
             (`telemetry.metrics_text()`: counters, gauges and
             cumulative `_bucket` / `_sum` / `_count` histogram series).
  /healthz   liveness: `ok` and 200 while the thread is up.
  /statusz   JSON of the registered status providers: the resolved
             YDF_TPU_* knobs (`config`) and the MemoryLedger (`memory`).

Enablement follows the failpoints/telemetry zero-overhead contract:

  * `YDF_TPU_METRICS_PORT=<port>`: validated at import. Port 0 binds an
    ephemeral port. Unset or empty = OFF: `maybe_start_from_env()`
    returns None without a thread or a socket.
  * Programmatic: `start_metrics_server(port=0)` -> `MetricsServer` with
    `.port` and `.close()`.

The server binds 127.0.0.1 by default. Handlers never raise into the
serving thread: a broken status provider degrades to an "error" field,
and every request is answered.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from ydf_tpu_torch.utils import telemetry

__all__ = [
    "METRICS_PORT",
    "MetricsServer",
    "start_metrics_server",
    "maybe_start_from_env",
    "register_status",
    "unregister_status",
    "status_snapshot",
]


def _parse_metrics_port(raw: Optional[str]) -> Optional[int]:
    """Validates YDF_TPU_METRICS_PORT eagerly. None/empty → endpoints
    off; 0 → ephemeral port; else a valid TCP port."""
    if raw is None or not raw.strip():
        return None
    try:
        v = int(raw)
    except ValueError:
        raise ValueError(
            f"YDF_TPU_METRICS_PORT={raw!r} is not an integer port"
        ) from None
    if not 0 <= v <= 65535:
        raise ValueError(
            f"YDF_TPU_METRICS_PORT={raw} is outside [0, 65535]"
        )
    return v


METRICS_PORT: Optional[int] = _parse_metrics_port(
    os.environ.get("YDF_TPU_METRICS_PORT")
)


# --------------------------------------------------------------------- #
# Status providers (/statusz)
# --------------------------------------------------------------------- #

_STATUS_LOCK = threading.Lock()
_STATUS: Dict[str, Callable[[], dict]] = {}


def register_status(name: str, fn: Callable[[], dict]) -> None:
    """Registers (or replaces) a /statusz section: `fn()` returns a
    JSON-able dict sampled at request time. Registration is cheap and
    independent of whether a server is running."""
    with _STATUS_LOCK:
        _STATUS[name] = fn


def unregister_status(name: str) -> None:
    with _STATUS_LOCK:
        _STATUS.pop(name, None)


def _config_status() -> dict:
    """The /statusz `config` section: every YDF_TPU_* knob of the port
    as its module resolved it (the validated values, not raw
    os.environ)."""
    from ydf_tpu_torch.utils import failpoints, log

    return {
        "YDF_TPU_TELEMETRY": telemetry.ENABLED,
        "YDF_TPU_TELEMETRY_DIR": telemetry.EXPORT_DIR,
        "YDF_TPU_MEM_SAMPLE": telemetry.MEM_SAMPLE,
        "YDF_TPU_LOG": log.LEVEL,
        "YDF_TPU_FAILPOINTS": sorted(failpoints.parse(
            os.environ.get("YDF_TPU_FAILPOINTS", ""))),
        "YDF_TPU_METRICS_PORT": METRICS_PORT,
        "YDF_TPU_PROFILE_DIR": os.environ.get("YDF_TPU_PROFILE_DIR") or None,
    }


def _memory_status() -> dict:
    """The /statusz `memory` section: the MemoryLedger snapshot —
    per-subsystem byte gauges plus current/peak RSS."""
    return telemetry.ledger().snapshot()


# Default sections every process serves (cheap registration; sampled
# only when a scrape asks).
register_status("config", _config_status)
register_status("memory", _memory_status)


def status_snapshot() -> dict:
    """All registered sections; a broken provider degrades to an error
    string instead of failing the whole page."""
    with _STATUS_LOCK:
        providers = list(_STATUS.items())
    out: dict = {"pid": os.getpid(), "trace": telemetry.TRACE_ID}
    for name, fn in providers:
        try:
            out[name] = fn()
        except Exception as e:
            out[name] = {"error": f"{type(e).__name__}: {e}"}
    return out


# --------------------------------------------------------------------- #
# The server
# --------------------------------------------------------------------- #


class _Handler(BaseHTTPRequestHandler):
    # Close per request: scrapers reconnect, and lingering keep-alive
    # sockets would pin handler threads.
    protocol_version = "HTTP/1.0"

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        try:
            path = self.path.split("?", 1)[0]
            if path == "/metrics":
                body = telemetry.metrics_text().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/healthz":
                body, ctype = b"ok\n", "text/plain; charset=utf-8"
            elif path == "/statusz":
                body = (
                    json.dumps(status_snapshot(), indent=2, default=str)
                    + "\n"
                ).encode()
                ctype = "application/json"
            else:
                self.send_error(404)
                return
            if telemetry.ENABLED:
                telemetry.counter(
                    "ydf_metrics_http_requests_total", path=path
                ).inc()
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except BrokenPipeError:
            pass  # scraper went away mid-response
        except Exception:
            try:
                self.send_error(500)
            except Exception:
                pass

    def log_message(self, fmt, *args):  # stderr stays quiet by default
        from ydf_tpu_torch.utils import log

        log.debug(f"telemetry_http: {fmt % args}")


class MetricsServer:
    """A running exposition server: daemon accept thread, `.port` for
    ephemeral binds, idempotent `.close()`."""

    def __init__(self, port: int, host: str = "127.0.0.1"):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            daemon=True,
            name="ydf-telemetry-http",
        )
        self._thread.start()

    def url(self, path: str = "/metrics") -> str:
        return f"http://{self.host}:{self.port}{path}"

    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


_SERVER: Optional[MetricsServer] = None
_SERVER_LOCK = threading.Lock()


def start_metrics_server(
    port: Optional[int] = None, host: str = "127.0.0.1"
) -> MetricsServer:
    """Starts (or returns) the process's exposition server: one server
    per process (its metrics live in the one process registry)."""
    global _SERVER
    with _SERVER_LOCK:
        if _SERVER is not None:
            return _SERVER
        if port is None:
            port = METRICS_PORT if METRICS_PORT is not None else 0
        _SERVER = MetricsServer(port, host=host)
        from ydf_tpu_torch.utils import log

        log.debug(
            f"telemetry_http: serving /metrics /healthz /statusz on "
            f"{host}:{_SERVER.port}"
        )
        return _SERVER


def maybe_start_from_env() -> Optional[MetricsServer]:
    """Starts the server iff YDF_TPU_METRICS_PORT is set — the zero-
    overhead default: unset means no thread, no socket, nothing."""
    if METRICS_PORT is None:
        return None
    return start_metrics_server(METRICS_PORT)


def _reset_for_tests() -> None:
    """Closes and forgets the process server (tests only)."""
    global _SERVER
    with _SERVER_LOCK:
        if _SERVER is not None:
            _SERVER.close()
            _SERVER = None
