"""Shared stdlib HTTP plumbing of the serving listener.

The port's copy of lightgbm_tpu/serve/httpbase.py: JSON/text response
writing with a correct Content-Length, http.server's log chatter routed to
the debug log instead of stderr, and a threaded server whose handler
threads are daemons, so none can block interpreter exit. Stdlib only.
"""
from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict

from ..utils import log

#: the /metrics content type every scrape endpoint advertises
PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class JsonHandler(BaseHTTPRequestHandler):
    """BaseHTTPRequestHandler with the response/logging mechanics of a
    listener; subclasses add routes (do_GET/do_POST) and set
    ``server_version`` + ``log_prefix``."""

    server_version = "lightgbm-tpu-torch/1.0"
    #: prefix for routed log lines ("serve", ...)
    log_prefix = "http"

    def log_message(self, fmt, *args):  # route http.server chatter to debug
        log.debug("%s: %s" % (self.log_prefix, fmt % args))

    def _json(self, code: int, payload: Dict) -> None:
        self._text(code, json.dumps(payload), "application/json")

    def _text(self, code: int, text: str, ctype: str) -> None:
        body = text.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class DaemonHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer whose handler threads are daemons: neither a
    wedged scrape nor a slow client can hold the process open at exit."""

    daemon_threads = True
