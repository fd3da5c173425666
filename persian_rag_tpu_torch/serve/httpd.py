"""HTTP server base for the port's serving surfaces.

A JAX-free copy of ``persian_rag_tpu.serve.httpd``. stdlib
ThreadingHTTPServer defaults to a listen backlog of 5
(socketserver.TCPServer.request_queue_size): a burst of more than ~5
simultaneous connects gets RST at the socket level before a handler
thread runs. A coalescing server exists to absorb such bursts, so the
accept queue is sized to the burst, and handler threads are daemons so a
stuck client cannot block interpreter exit.
"""
from __future__ import annotations

from http.server import ThreadingHTTPServer


class BurstHTTPServer(ThreadingHTTPServer):
    request_queue_size = 512
    daemon_threads = True
