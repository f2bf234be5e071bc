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
each finished stage's wall seconds (``stage_s``).

With ``cfg.devices = N > 1`` the service is N ranks of one torch.distributed
group, one process per device (started by torchrun, as ``cli reconstruct
--devices N`` is), each building the same StagedPipeline (workspace, config,
seed) over the group's mesh.  Rank 0 binds the server and answers every
request as above (``device`` is rank 0's); uploads are written by rank 0
alone into the workspace the ranks share on one host.  Ranks 1..N-1 bind
nothing: they follow rank 0's stage commands, call the same stage method
and report its outcome.  Commands and outcomes pass through a TCPStore that
rank 0 hosts, polled, so a follower may wait for the next upload for ever:
no collective is pending while the service is idle.  A stage ends (``busy``
clears) once every rank has reported; a rank's error reaches /status and
the ``error`` event with its rank named.  An error that every rank raises
leaves the service serving.  An error on one rank alone leaves the others
waiting in a collective it left: the ranks are then out of step, which each
rank sees within PEER_GRACE_S of that error; /status says so, every stage
trigger answers 503, a follower exits at once and rank 0's ``serve`` exits
after FAILED_LINGER_S more of answering, all with code 1."""

from __future__ import annotations

import datetime
import json
import os
import re
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import torch.distributed as dist

from ..parallel import mesh as mesh_mod
from ..pipeline.config import PipelineConfig
from ..pipeline.staged import StagedPipeline
from ..utils.events import EventBus

# The stage triggers and the StagedPipeline method each runs on every rank.
STAGE_METHODS = {"preprocessing": "preprocess", "sparse": "sparse", "dense": "dense",
                 "mesh": "mesh"}
POLL_S = 0.2            # how often a waiting rank reads the command store
PEER_GRACE_S = 30.0     # how long a rank waits for the others' outcomes of a stage
FAILED_LINGER_S = 60.0  # how long rank 0's serve() answers after the ranks fell out of step


def _describe(errors: dict[int, str]) -> str:
    """'rank 1: E', or 'ranks 0, 1: E' for an error those ranks share."""
    by_error: dict[str, list[int]] = {}
    for r in sorted(errors):
        by_error.setdefault(errors[r], []).append(r)
    return "; ".join(f"rank{'s' if len(rs) > 1 else ''} {', '.join(map(str, rs))}: {e}"
                     for e, rs in by_error.items())


def _exit_out_of_step(rank: int, why: str) -> None:
    """End this rank's process with code 1: its group cannot be left
    cleanly while another rank waits in a collective."""
    print(f"tpusfm_torch service, rank {rank}: {why}; exiting", file=sys.stderr, flush=True)
    sys.stdout.flush()
    os._exit(1)


class _Ranks:
    """The command channel of a multi-rank service, on a TCPStore that rank 0
    hosts on 127.0.0.1 (the ranks share one host and its workspace): rank
    0's stage commands (cmd/<seq>), each rank's outcome of a stage
    (out/<seq>/<rank>: ok, error, seconds) and why the ranks fell out of
    step (failed)."""

    def __init__(self, mesh):
        self.rank, self.size, self.seq = mesh.rank, mesh.size, 0
        timeout = datetime.timedelta(seconds=mesh_mod.TIMEOUT_S)
        host = (dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False,
                              timeout=timeout) if self.rank == 0 else None)
        port = mesh_mod.broadcast_ints(mesh, [host.port if host else 0])[0]
        self.store = host or dist.TCPStore("127.0.0.1", port, is_master=False, timeout=timeout)

    def _set(self, key: str, value) -> None:
        self.store.set(key, json.dumps(value))

    def _get(self, key: str):
        return json.loads(self.store.get(key)) if self.store.check([key]) else None

    def failed(self) -> str | None:
        return self._get("failed")

    def fail(self, why: str) -> str:
        """Record why the ranks are out of step; the first reason stays and
        is returned."""
        return json.loads(self.store.compare_set("failed", "", json.dumps(why)))

    def command(self, stage: str) -> None:
        """Rank 0: the next command, a stage name or "stop"."""
        self.seq += 1
        self._set(f"cmd/{self.seq}", stage)

    def next_command(self) -> str | None:
        """Ranks >= 1: wait, for ever, for rank 0's next command; None once
        the ranks are out of step."""
        key = f"cmd/{self.seq + 1}"
        while not self.store.check([key]):
            if self.store.check(["failed"]):
                return None
            time.sleep(POLL_S)
        self.seq += 1
        return self._get(key)

    def report(self, outcome: dict) -> None:
        self._set(f"out/{self.seq}/{self.rank}", outcome)

    def outcomes(self) -> dict[int, dict]:
        """The outcomes of the current command reported so far, by rank."""
        keys = {r: f"out/{self.seq}/{r}" for r in range(self.size)}
        return {r: self._get(k) for r, k in keys.items() if self.store.check([k])}

    def _out_of_step(self, got: dict[int, dict]) -> str:
        errors = {r: o["error"] for r, o in got.items() if not o["ok"]}
        waiting = [r for r in range(self.size) if r not in got]
        head = _describe(errors) + "; " if errors else ""
        return (f"{head}rank{'s' if len(waiting) > 1 else ''} {', '.join(map(str, waiting))} "
                f"still in the stage after {PEER_GRACE_S:g} s: the ranks are out of step")

    def run(self, fn, on_out_of_step) -> tuple[dict[int, dict], str | None]:
        """fn() as this rank's part of the current stage, then every rank's
        outcome: (outcomes by rank, None), or (those reported, why the ranks
        are out of step) when a rank's error or this rank's end was not
        followed within PEER_GRACE_S by every outcome, or another rank found
        them so.  While fn runs, on_out_of_step(why) is called once they are
        (this rank then waits in a collective that another rank left)."""
        done, seen = threading.Event(), {}
        watcher = threading.Thread(target=self._watch, args=(done, on_out_of_step, seen),
                                   daemon=True)
        watcher.start()
        t0 = time.time()
        try:
            fn()
            out = {"ok": True, "error": None}
        except Exception as e:
            traceback.print_exc()
            out = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        self.report({**out, "s": round(time.time() - t0, 3)})
        done.set()
        watcher.join()
        return seen["got"], seen["why"]

    def _watch(self, done: threading.Event, on_out_of_step, seen: dict) -> None:
        """Read the outcomes until every rank's is in or the ranks are out
        of step; leaves them, and why, in `seen`."""
        since = None
        while True:
            got, why = self.outcomes(), self.failed()
            if why is None and len(got) == self.size:
                break
            if why is None and (done.is_set() or any(not o["ok"] for o in got.values())):
                since = since or time.time()
                if time.time() - since > PEER_GRACE_S:
                    why = self.fail(self._out_of_step(got))
            if why is not None:
                if not done.is_set():
                    on_out_of_step(why)
                break
            time.sleep(POLL_S)
        seen.update(got=got, why=why)

    def stop(self) -> None:
        """Rank 0: tell the followers to stop and wait (up to PEER_GRACE_S)
        for each to acknowledge."""
        self.command("stop")
        end = time.time() + PEER_GRACE_S
        while (len(self.outcomes()) < self.size - 1 and time.time() < end
               and self.failed() is None):
            time.sleep(POLL_S)


class ServiceState:
    def __init__(self, workspace: str, cfg: PipelineConfig, *, device="cuda", seed: int = 0):
        """With cfg.devices = N > 1 every rank of the group builds its state
        at the same time (the pipeline's and the command channel's groups)."""
        self.bus = EventBus()
        self.pipeline = StagedPipeline(workspace, cfg, bus=self.bus, device=device, seed=seed)
        self.lock = threading.Lock()
        self.busy_stage: str | None = None
        self.last_error: str | None = None
        self.stage_s: dict[str, float] = {}
        mesh = self.pipeline.device_mesh
        self.rank = 0 if mesh is None else mesh.rank
        self.ranks = None if mesh is None else _Ranks(mesh)
        # Multi-rank: each rank's seconds in each stage, and why the ranks
        # fell out of step (set once; world_down is set with it).
        self.rank_stage_s: dict[str, dict[int, float]] = {}
        self.failed: str | None = None
        self.world_down = threading.Event()
        self._stopped = False

    def run_stage(self, name: str, fn) -> bool:
        """Start a stage in a worker thread; False if something is running.
        With ranks, `name` is a key of STAGE_METHODS and every rank runs
        that method: rank 0 runs `fn`, the pipeline's own method."""
        if self.ranks is not None and name not in STAGE_METHODS:
            raise ValueError(f"a multi-rank service runs only {sorted(STAGE_METHODS)}")
        with self.lock:
            if self.busy_stage:
                return False
            self.busy_stage = name
        work = self._work if self.ranks is None else self._work_ranks
        threading.Thread(target=work, args=(name, fn), daemon=True).start()
        return True

    def _work(self, name: str, fn) -> None:
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

    def _work_ranks(self, name: str, fn) -> None:
        t0 = time.time()
        self.ranks.command(name)
        got, why = self.ranks.run(lambda: (fn(), self.pipeline.sync()),
                                  lambda why: self._fall_out(name, why))
        if why is not None:
            return self._fall_out(name, why)
        errors = {r: o["error"] for r, o in got.items() if not o["ok"]}
        self.rank_stage_s[name] = {r: o["s"] for r, o in sorted(got.items())}
        if errors:
            self.last_error = _describe(errors)
            self.bus.publish("error", 1.0, stage=name, error=self.last_error,
                             ranks=sorted(errors))
        else:
            self.stage_s[name] = round(time.time() - t0, 3)
            self.last_error = None
        with self.lock:
            self.busy_stage = None

    def _fall_out(self, name: str, why: str) -> None:
        """Rank 0: the ranks are out of step; the service answers no more
        stage triggers."""
        with self.lock:
            if self.failed is not None:
                return
            self.failed = self.last_error = why
            self.busy_stage = None
        failing = sorted(r for r, o in self.ranks.outcomes().items() if not o["ok"])
        self.bus.publish("error", 1.0, stage=name, error=why, ranks=failing)
        self.world_down.set()

    def follow(self) -> None:
        """Ranks >= 1: run rank 0's stage commands until it stops the
        service.  Raises RuntimeError when the ranks are out of step; while
        this rank waits in a collective another rank left, its process
        exits with code 1 instead."""
        if self.ranks is None or self.rank == 0:
            raise ValueError("follow() runs on ranks 1..N-1 of a multi-rank service")
        try:
            self._follow()
        except KeyboardInterrupt:  # Ctrl-C to the whole group: rank 0 need not wait for us
            self.ranks.fail(f"rank {self.rank} was interrupted")
            raise

    def _follow(self) -> None:
        while True:
            cmd = self.ranks.next_command()
            if cmd is None:
                raise RuntimeError(f"the ranks are out of step: {self.ranks.failed()}")
            if cmd == "stop":
                self.ranks.report({"ok": True, "error": None, "s": 0.0})
                return
            fn = getattr(self.pipeline, STAGE_METHODS[cmd])
            _, why = self.ranks.run(lambda: (fn(), self.pipeline.sync()),
                                    lambda why: _exit_out_of_step(self.rank, why))
            if why is not None:
                raise RuntimeError(f"the ranks are out of step: {why}")

    def close(self) -> None:
        """Rank 0 of a multi-rank service: stop the followers once the
        running stage has ended.  A stage still running after PEER_GRACE_S
        puts the ranks out of step, so that the followers exit (code 1).
        Nothing to do for one process."""
        if self.ranks is None or self.rank != 0 or self._stopped:
            return
        self._stopped = True
        end = time.time() + PEER_GRACE_S
        while self.busy_stage is not None and self.failed is None and time.time() < end:
            time.sleep(POLL_S)
        stage = self.busy_stage
        if self.failed is None and stage is not None:
            self._fall_out(stage, self.ranks.fail(
                f"rank 0 stopped the service with stage {stage} still running after "
                f"{PEER_GRACE_S:g} s: the ranks are out of step"))
        elif self.failed is None:
            self.ranks.stop()


class _Server(ThreadingHTTPServer):
    """Rank 0's HTTP server; closing it stops the followers."""

    def __init__(self, address, state: ServiceState):
        super().__init__(address, make_handler(state))
        self.state = state

    def server_close(self):
        super().server_close()
        self.state.close()


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
            if route[1:] in STAGE_METHODS and state.failed:
                return self._json({"status": "error", "error": state.failed}, 503)
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


def _exit_when_out_of_step(state: ServiceState) -> None:
    state.world_down.wait()
    time.sleep(FAILED_LINGER_S)
    _exit_out_of_step(0, state.failed)


def serve(workspace: str, cfg: PipelineConfig | None = None,
          host: str = "localhost", port: int = 8080, *, device="cuda", seed: int = 0):
    """Blocking server start (reference binds localhost:8080, main.cpp:312).
    With cfg.devices = N > 1 every rank calls it: rank 0 serves until
    stopped (KeyboardInterrupt), then stops the followers; ranks 1..N-1
    follow until then.  When the ranks fall out of step each process exits
    with code 1, rank 0 after FAILED_LINGER_S more of answering."""
    state = ServiceState(workspace, cfg or PipelineConfig(), device=device, seed=seed)
    if state.rank != 0:
        try:
            state.follow()
        except RuntimeError as e:
            _exit_out_of_step(state.rank, str(e))
        return
    httpd = _Server((host, port), state)
    ranks = "" if state.ranks is None else f", {state.ranks.size} ranks"
    print(f"tpusfm_torch service on http://{host}:{port} (workspace {workspace}, "
          f"device {state.pipeline.device}{ranks})", flush=True)
    if state.ranks is not None:
        threading.Thread(target=_exit_when_out_of_step, args=(state,), daemon=True).start()
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()


def start_background(workspace: str, cfg: PipelineConfig | None = None,
                     host: str = "localhost", port: int = 0, *, device="cuda",
                     seed: int = 0):
    """Non-blocking start; returns (httpd, state, port).  Stop it with
    ``httpd.shutdown()`` and ``httpd.server_close()`` (which, with ranks,
    stops the followers).  With cfg.devices = N > 1 this is rank 0's
    entry; ranks 1..N-1 call ``follow`` at the same time."""
    state = ServiceState(workspace, cfg or PipelineConfig(), device=device, seed=seed)
    httpd = _Server((host, port), state)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    return httpd, state, httpd.server_address[1]


def follow(workspace: str, cfg: PipelineConfig, *, device="cuda", seed: int = 0) -> ServiceState:
    """Ranks 1..N-1 of a multi-rank service beside rank 0's
    ``start_background``: build this rank's state and follow rank 0's
    commands until it stops the service; returns the state.  Raises
    RuntimeError when the ranks fall out of step."""
    state = ServiceState(workspace, cfg, device=device, seed=seed)
    state.follow()
    return state
