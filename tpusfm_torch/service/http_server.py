"""HTTP facade with SSE progress events (port of
``tpusfm/service/http_server.py``).

Endpoint-for-endpoint parity with the reference service (src/main.cpp:
195-312): multipart POST /upload into the workspace image dir
(main.cpp:235-268), stage-trigger GETs /preprocessing /sparse /dense /mesh
(270-308), chunked text/event-stream GET /event with JSON ``data:`` frames
(227-233, create_event 195-205), permissive CORS (207-211), default bind
localhost:8080 (312).  Responses mirror the reference's "<stage> begin" /
busy-state replies and the /sparse result URL of the colorized PLY
(281-285).  Artifacts are additionally served read-only under /files/.

Implementation: stdlib ThreadingHTTPServer — one worker thread runs stages
(the reference blocks its handler thread; here triggers return immediately
like its event-driven clients expect, with state polled via /event).  The
stages run on the service's device, ``"cuda"`` unless the caller asks for
the CPU; the pipeline passes that device to every call, so the worker
thread's current device plays no part.  /status also gives the device and
each finished stage's wall seconds (``stage_s``)."""

from __future__ import annotations

import json
import re
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

from ..pipeline.config import PipelineConfig
from ..pipeline.staged import StagedPipeline
from ..utils.events import EventBus


class ServiceState:
    def __init__(self, workspace: str, cfg: PipelineConfig, *, device="cuda", seed: int = 0):
        if cfg.devices is not None and cfg.devices > 1:
            raise NotImplementedError(
                "the service runs one process: devices > 1 would need every stage command "
                "broadcast to the other ranks (ROADMAP queue 1); run the CLI under torchrun "
                "for a multi-device reconstruction")
        self.bus = EventBus()
        self.pipeline = StagedPipeline(workspace, cfg, bus=self.bus, device=device, seed=seed)
        self.lock = threading.Lock()
        self.busy_stage: str | None = None
        self.last_error: str | None = None
        self.stage_s: dict[str, float] = {}

    def run_stage(self, name: str, fn) -> bool:
        """Start a stage in a worker thread; False if something is running."""
        with self.lock:
            if self.busy_stage:
                return False
            self.busy_stage = name

        def work():
            t0 = time.time()
            try:
                fn()
                self.pipeline.sync()
                self.stage_s[name] = round(time.time() - t0, 3)
                self.last_error = None
            except Exception as e:  # surfaces via /event + /status
                self.last_error = f"{type(e).__name__}: {e}"
                self.bus.publish("error", 1.0, stage=name, error=self.last_error)
                traceback.print_exc()
            finally:
                with self.lock:
                    self.busy_stage = None

        threading.Thread(target=work, daemon=True).start()
        return True


def make_handler(state: ServiceState):
    ws = state.pipeline.ws

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet
            pass

        # -- helpers -------------------------------------------------------

        def _cors(self):
            # Parity: main.cpp:207-211 set_default_headers.
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Access-Control-Allow-Methods", "*")
            self.send_header("Access-Control-Allow-Headers", "*")

        def _reply(self, body: str | bytes, code=200, ctype="text/plain"):
            data = body.encode() if isinstance(body, str) else body
            self.send_response(code)
            self._cors()
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _json(self, obj, code=200):
            self._reply(json.dumps(obj), code, "application/json")

        # -- routes --------------------------------------------------------

        def do_OPTIONS(self):
            self._reply("", 204)

        def do_POST(self):
            if self.path == "/upload":
                return self._upload()
            self._reply("not found", 404)

        def do_GET(self):
            route = self.path.split("?")[0]
            if route == "/event":
                return self._events()
            if route == "/status":
                return self._json({
                    "busy": state.busy_stage,
                    "error": state.last_error,
                    "workspace": str(ws),
                    "device": str(state.pipeline.device),
                    "stage_s": dict(state.stage_s),
                    "artifacts": sorted(
                        p.name for p in ws.iterdir() if p.is_file()
                    ),
                })
            if route == "/preprocessing":
                ok = state.run_stage("preprocessing", state.pipeline.preprocess)
                return self._reply("preprocessing begin" if ok else "busy", 200 if ok else 409)
            if route == "/sparse":
                ok = state.run_stage("sparse", state.pipeline.sparse)
                if not ok:
                    return self._reply("busy", 409)
                # Parity: /sparse returns the colorized PLY URL (main.cpp:281-285).
                return self._json({"status": "sparse begin",
                                   "result": "/files/colorized.ply"})
            if route == "/dense":
                ok = state.run_stage("dense", state.pipeline.dense)
                return self._json({"status": "dense begin" if ok else "busy",
                                   "result": "/files/dense.ply"}, 200 if ok else 409)
            if route == "/mesh":
                ok = state.run_stage("mesh", state.pipeline.mesh)
                return self._json({"status": "mesh begin" if ok else "busy",
                                   "result": "/files/mesh.ply"}, 200 if ok else 409)
            if route.startswith("/files/"):
                return self._serve_file(route[len("/files/"):])
            if route == "/":
                return self._json({"service": "tpusfm", "endpoints": [
                    "/upload", "/preprocessing", "/sparse", "/dense", "/mesh",
                    "/event", "/status", "/files/<artifact>",
                ]})
            self._reply("not found", 404)

        # -- implementations ----------------------------------------------

        def _serve_file(self, rel: str):
            target = (ws / rel).resolve()
            if not target.is_relative_to(ws.resolve()) or not target.is_file():
                return self._reply("not found", 404)
            self._reply(target.read_bytes(), 200, "application/octet-stream")

        def _upload(self):
            # Parity: multipart files land in the image dir (main.cpp:235-268).
            ctype = self.headers.get("Content-Type", "")
            m = re.search(r"boundary=([^;]+)", ctype)
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            if not m:
                return self._reply("expected multipart/form-data", 400)
            boundary = m.group(1).strip('"').encode()
            saved = []
            # RFC 2046 framing: parts are delimited by CRLF + "--" +
            # boundary; the delimiter's leading CRLF belongs to the
            # FRAMING, not the content.  (A blanket rstrip of '-'/CR/LF
            # would corrupt binary payloads whose last bytes happen to be
            # those values.)
            delim = b"\r\n--" + boundary
            # The first boundary has no leading CRLF; normalize.
            payload = b"\r\n" + body
            for part in payload.split(delim)[1:]:
                if part.startswith(b"--"):  # closing delimiter
                    break
                if part.startswith(b"\r\n"):
                    part = part[2:]
                if b"\r\n\r\n" not in part:
                    continue
                head, content = part.split(b"\r\n\r\n", 1)
                fn = re.search(rb'filename="([^"]+)"', head)
                if not fn:
                    continue
                name = Path(fn.group(1).decode(errors="replace")).name
                out = state.pipeline.image_dir() / name
                out.write_bytes(content)
                saved.append(name)
            self._json({"saved": saved})

        def _events(self):
            # Parity: chunked text/event-stream of JSON frames (main.cpp:227).
            self.send_response(200)
            self._cors()
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def send_chunk(text: str):
                data = text.encode()
                self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
                self.wfile.flush()

            q = state.bus.subscribe()
            try:
                # Replay history so late subscribers see prior progress.
                for ev in list(state.bus.history[-20:]):
                    send_chunk(f"data: {ev.to_json()}\n\n")
                while True:
                    try:
                        ev = q.get(timeout=15.0)
                        send_chunk(f"data: {ev.to_json()}\n\n")
                    except Exception:
                        send_chunk(": keepalive\n\n")
            except (BrokenPipeError, ConnectionResetError):
                pass
            finally:
                state.bus.unsubscribe(q)

    return Handler


def serve(workspace: str, cfg: PipelineConfig | None = None,
          host: str = "localhost", port: int = 8080, *, device="cuda", seed: int = 0):
    """Blocking server start (reference binds localhost:8080, main.cpp:312)."""
    state = ServiceState(workspace, cfg or PipelineConfig(), device=device, seed=seed)
    httpd = ThreadingHTTPServer((host, port), make_handler(state))
    print(f"tpusfm_torch service on http://{host}:{port} (workspace {workspace}, "
          f"device {state.pipeline.device})")
    httpd.serve_forever()


def start_background(workspace: str, cfg: PipelineConfig | None = None,
                     host: str = "localhost", port: int = 0, *, device="cuda",
                     seed: int = 0):
    """Non-blocking start; returns (httpd, state, port).  Stop it with
    ``httpd.shutdown()`` and ``httpd.server_close()``."""
    state = ServiceState(workspace, cfg or PipelineConfig(), device=device, seed=seed)
    httpd = ThreadingHTTPServer((host, port), make_handler(state))
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    return httpd, state, httpd.server_address[1]
