"""Live dock viewing: MJPEG-over-HTTP sink (counterpart of
``obs_color_monitor_tpu/pipeline/live.py``, a copy).

The reference's output surface is a Qt dock repainted per display frame
(reference src/scope-widget.cpp:99-175 draws inside OBS's render loop); a
standalone framework needs its own live surface.  This one is the classic
MJPEG stream: a tiny stdlib HTTP server pushes each published panel as a
JPEG part of one endless ``multipart/x-mixed-replace`` response — every
browser renders it natively, nothing is vendored, and the producer side is
a single ``publish(rgba)`` call per frame.

Endpoints:
  /        minimal HTML page embedding the stream
  /stream  the multipart MJPEG stream itself
  /frame   one still of the latest panel (curl-able health check)
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ..utils.image_io import encode_frame

_BOUNDARY = b"ocmframe"

_PAGE = b"""<!doctype html>
<html><head><title>obs-color-monitor-tpu</title>
<style>body{margin:0;background:#111;display:flex;justify-content:center}
img{max-height:100vh}</style></head>
<body><img src="/stream" alt="scope dock stream"></body></html>
"""


class MJPEGServer:
    """Threaded MJPEG sink: ``publish()`` frames, browsers watch ``/``.

    ``publish`` never blocks on slow clients: each client coroutine waits on
    a condition for the next frame and always sends only the LATEST one
    (frame dropping per client, like the capture queue's drop-on-full —
    a stalled viewer sees fewer frames, the pipeline never stalls).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._cond = threading.Condition()
        self._frame: Optional[bytes] = None
        self._raw: Optional[np.ndarray] = None  # pre-encode panel (lazy)
        self._quality = 80
        self._ctype = "image/jpeg"
        self._seq = 0
        self._n_stream_clients = 0
        self.n_published = 0
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def setup(self):
                super().setup()
                # a viewer that stops reading (TCP zero window) must not
                # pin its handler thread forever past stop(): stalled
                # writes abort after this timeout
                self.connection.settimeout(10.0)

            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(_PAGE)))
                    self.end_headers()
                    self.wfile.write(_PAGE)
                elif self.path == "/frame":
                    data, ctype = outer._latest()
                    if data is None:
                        self.send_response(503)
                        self.send_header("Content-Length", "0")
                        self.end_headers()
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif self.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        f"multipart/x-mixed-replace; "
                        f"boundary={_BOUNDARY.decode()}",
                    )
                    self.end_headers()
                    seen = -1
                    with outer._cond:
                        outer._n_stream_clients += 1
                    try:
                        while True:
                            with outer._cond:
                                outer._cond.wait_for(
                                    lambda: outer._seq != seen
                                    or outer._closed,
                                    timeout=1.0,
                                )
                                if outer._closed:
                                    return
                                if outer._seq == seen:
                                    continue
                                data, ctype = outer._encode_locked()
                                seen = outer._seq
                            if data is None:
                                continue
                            self.wfile.write(
                                b"--" + _BOUNDARY + b"\r\n"
                                + f"Content-Type: {ctype}\r\n"
                                  f"Content-Length: {len(data)}\r\n\r\n".encode()
                                + data + b"\r\n"
                            )
                    except OSError:
                        return  # viewer went away / stalled past timeout
                    finally:
                        with outer._cond:
                            outer._n_stream_clients -= 1
                else:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()

        self._closed = False
        self._started = False
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="ocm-mjpeg", daemon=True
        )

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "MJPEGServer":
        self._thread.start()
        self._started = True
        return self

    def stop(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._started:
            # shutdown() waits on an event only serve_forever() sets —
            # calling it on a never-started server would block forever
            self._httpd.shutdown()
        self._httpd.server_close()

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}/"

    # -- producer ------------------------------------------------------------
    def publish(self, rgba: np.ndarray, quality: int = 80) -> None:
        """Publish one (H, W, 3|4) u8 panel (non-blocking).

        JPEG encoding is skipped while no /stream client is connected (on
        a host with few cores the encode would steal producer time for nobody);
        the raw panel is kept and encoded lazily on first demand."""
        with self._cond:
            encode_now = self._n_stream_clients > 0
        data = ctype = None
        if encode_now:
            data, ctype = encode_frame(rgba, quality=quality)
        with self._cond:
            self._raw, self._quality = rgba, quality
            if encode_now:
                self._frame, self._ctype = data, ctype
            else:
                self._frame = None  # stale encode; re-encode on demand
            self._seq += 1
            self.n_published += 1
            self._cond.notify_all()

    def _encode_locked(self):
        """Latest encoded frame; encodes the kept raw panel on demand.
        Caller holds self._cond."""
        if self._frame is None and self._raw is not None:
            self._frame, self._ctype = encode_frame(
                self._raw, quality=self._quality
            )
        return self._frame, self._ctype

    def _latest(self):
        with self._cond:
            return self._encode_locked()
