"""HTTP adapters over the framework-agnostic route table.

Two adapters serve :data:`genrec_tpu_torch.backend.api.ROUTES`:

- :func:`serve` / :class:`BackendHTTPServer` — stdlib
  ``http.server.ThreadingHTTPServer``. Zero dependencies; this is the
  one the port's tests and its chip smoke drive.
- :func:`create_fastapi_app` — builds a FastAPI app from the same
  table when fastapi is installed (CORS config mirrors the reference
  app factory, `backend/app/main.py:29-55`).

Both return identical JSON bodies for identical requests, asserted by
`tests/test_torch_backend.py` (the FastAPI side where fastapi is installed).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qsl, unquote, urlsplit

from genrec_tpu_torch.backend.api import AppContext, match_route
from genrec_tpu_torch.backend.utils import ApiError, error_response, get_logger

logger = get_logger("genrec_backend.server")


def dispatch(ctx: AppContext, method: str, path: str,
             query: Dict[str, str], body: Dict[str, Any]
             ) -> Tuple[int, Any]:
    """Route + execute one request; ApiError maps to its status."""
    m = match_route(method, path)
    if m is None:
        return 404, error_response(f"{method} {path} not found")
    handler, path_params = m
    try:
        return handler(ctx, path_params, query, body)
    except ApiError as e:
        return e.status_code, e.body
    except Exception as e:  # handler bug → 500 with envelope
        logger.error("handler error on %s %s: %s", method, path, e)
        return 500, error_response(str(e))


class BackendHTTPServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, ctx: AppContext, host: str = "127.0.0.1",
                 port: int = 0):
        self.ctx = ctx
        super().__init__((host, port), _Handler)


class _Handler(BaseHTTPRequestHandler):
    server: BackendHTTPServer

    def log_message(self, fmt, *args):  # route through our logger
        logger.debug("%s " + fmt, self.address_string(), *args)

    def _respond(self, status: int, payload: Any) -> None:
        raw = json.dumps(payload, ensure_ascii=False).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json; charset=utf-8")
        self.send_header("Content-Length", str(len(raw)))
        origin = self.headers.get("Origin")
        if origin and origin in self.server.ctx.settings.cors_origins:
            self.send_header("Access-Control-Allow-Origin", origin)
        self.end_headers()
        self.wfile.write(raw)

    def _handle(self, method: str) -> None:
        url = urlsplit(self.path)
        query = dict(parse_qsl(url.query))
        body: Dict[str, Any] = {}
        length = int(self.headers.get("Content-Length") or 0)
        if length:
            try:
                body = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError:
                self._respond(400, error_response("invalid JSON body"))
                return
            if not isinstance(body, dict):
                # handlers index into the body; a bare list/str/number is a
                # client error, not a 500
                self._respond(400, error_response("JSON body must be an object"))
                return
        status, payload = dispatch(self.server.ctx, method, url.path,
                                   query, body)
        self._respond(status, payload)

    def do_GET(self):
        if self.path.startswith("/static/") and self._serve_static():
            return
        self._handle("GET")

    def _serve_static(self) -> bool:
        """Serve a file from settings.static_dir (reference mounts the
        production frontend bundle at /static, `backend/app/main.py:88-91`).
        Returns False when the mount is absent so the JSON 404 envelope
        applies, like any unmatched route."""
        import mimetypes
        import os
        root = self.server.ctx.settings.resolved_static_dir()
        if not os.path.isdir(root):
            return False
        # percent-decode BEFORE joining so encoded names (spaces, unicode)
        # resolve; the containment check below runs on the decoded path, so
        # an encoded '..' cannot sidestep it.
        rel = unquote(urlsplit(self.path).path[len("/static/"):])
        target = os.path.abspath(os.path.join(root, rel))
        # refuse path traversal out of the mount
        if not (target == root or target.startswith(root + os.sep)) \
                or not os.path.isfile(target):
            self._respond(404, error_response(f"GET {self.path} not found"))
            return True
        ctype = mimetypes.guess_type(target)[0] or "application/octet-stream"
        with open(target, "rb") as f:
            raw = f.read()
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)
        return True

    def do_POST(self):
        self._handle("POST")

    def do_PUT(self):
        self._handle("PUT")

    def do_DELETE(self):
        self._handle("DELETE")

    def do_OPTIONS(self):  # CORS preflight
        self.send_response(204)
        origin = self.headers.get("Origin")
        if origin and origin in self.server.ctx.settings.cors_origins:
            self.send_header("Access-Control-Allow-Origin", origin)
            self.send_header("Access-Control-Allow-Methods",
                             "GET, POST, PUT, DELETE, OPTIONS")
            self.send_header("Access-Control-Allow-Headers", "Content-Type")
        self.end_headers()


def serve(ctx: Optional[AppContext] = None, host: str = "0.0.0.0",
          port: int = 8000, background: bool = False) -> BackendHTTPServer:
    """Start the backend (reference: `backend/scripts/start.py` → uvicorn)."""
    ctx = ctx or AppContext.create()
    server = BackendHTTPServer(ctx, host, port)
    logger.info("backend listening on %s:%d", host, server.server_address[1])
    if background:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    else:
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            server.shutdown()
    return server


def create_fastapi_app(ctx: Optional[AppContext] = None):
    """FastAPI adapter over the same route table (requires fastapi)."""
    from fastapi import FastAPI, Request
    from fastapi.middleware.cors import CORSMiddleware
    from fastapi.responses import JSONResponse

    ctx = ctx or AppContext.create()
    app = FastAPI(title=ctx.settings.app_name, version=ctx.settings.version)
    app.add_middleware(CORSMiddleware,
                       allow_origins=ctx.settings.cors_origins,
                       allow_methods=["*"], allow_headers=["*"])

    # production frontend bundle (reference `backend/app/main.py:88-91`)
    import os
    if os.path.isdir(ctx.settings.resolved_static_dir()):
        from fastapi.staticfiles import StaticFiles
        app.mount("/static",
                  StaticFiles(directory=ctx.settings.resolved_static_dir()),
                  name="static")

    @app.api_route("/{full_path:path}",
                   methods=["GET", "POST", "PUT", "DELETE"])
    async def _dispatch(full_path: str, request: Request):
        body: Dict[str, Any] = {}
        raw = await request.body()
        if raw:
            try:
                body = json.loads(raw)
            except json.JSONDecodeError:
                return JSONResponse(error_response("invalid JSON body"), 400)
            if not isinstance(body, dict):
                return JSONResponse(
                    error_response("JSON body must be an object"), 400)
        status, payload = dispatch(ctx, request.method,
                                   "/" + full_path.strip("/"),
                                   dict(request.query_params), body)
        return JSONResponse(payload, status_code=status)

    return app
