"""Real-time controller serving loop on the card:

    python -m pyhybridcontrol_tpu_torch.serve --config double_integrator

Counterpart of ``pyhybridcontrol_tpu/serve.py``. The controller is built
once on ``--device`` (default ``cuda``; without a card the server exits
non-zero, it never carries on on the CPU).

stdin mode (default): one JSON request per line on stdin, one JSON
response per line on stdout.

TCP mode (``--tcp PORT``, 0 = ephemeral; the chosen port is printed in
the ready line): a line-delimited-JSON socket front serving many
concurrent clients from ONE resident controller. Single-state requests
arriving together — from the same or different connections — are
coalesced into one padded ``feedback_batch`` call (padded to the next
power of two), and the responses are demultiplexed back per client.
``--coalesce-window MS`` holds the batch open that long after the first
request (0 = batch only what is already queued); ``--max-batch`` caps it.
Device work stays on one thread.

Request:  {"x": [..nx..], "omega": [[..]] (N,nω) opt, "price": [[..]] opt,
           "u_prev": [..] opt, "id": any opt (echoed back),
           "deadline_ms": f opt (TCP mode: a request still queued past
           its deadline is shed with {"error": "deadline exceeded",
           "deadline_exceeded": true}; a queued deadline also pulls the
           coalescing window closed early, to half the deadline budget)}
Response: {"u": [..], "delta": [..], "obj": f, "found": b, "gap": f,
           "ms": f, "coalesced": B (TCP mode, when batched)}
A 2-D "x" ([[..nx..] × B]) solves the whole batch in one pooled B&B
(``MpcController.feedback_batch``) and returns list-valued
"u"/"delta"/"obj"/"found" with "batch" and "ms".
Send {"cmd": "ping"} for a health check, {"cmd": "stats"} for serving
counters (TCP mode), {"cmd": "quit"} to stop (stdin mode) / close the
connection (TCP mode), {"cmd": "shutdown"} to stop the TCP server.
"""

from __future__ import annotations

import argparse
import json
import queue
import socket
import sys
import threading
import time

import numpy as np


def make_controller(config: str, solver: str = "bnb", device="cuda"):
    """The built controller of ``config`` on ``device``, as served. The
    config's soft rows are softened (penalties 5.0 linear, 1.0 quadratic)
    as the reference's serve does; like it, serve applies no move blocking
    (the reference's ``run.py`` does)."""
    from pyhybridcontrol_tpu_torch.configs import get_config
    from pyhybridcontrol_tpu_torch.control.mpc import MpcController

    cfg = get_config(config)
    model, ckw = cfg.build()
    ctrl = MpcController(model, cfg.N, solver=solver, bnb_spec=cfg.bnb,
                         qp_iters=cfg.bnb.qp_iters, device=device, **ckw)
    if cfg.soft_rows:
        ctrl.set_soft_constraints(list(cfg.soft_rows), lin_pen=5.0,
                                  quad_pen=1.0)
    return ctrl.build()


def build_controller(config: str, solver: str = "bnb", device="cuda"):
    """``make_controller`` and one warmup solve (kernel build and first
    launch). Returns (ctrl, ready line)."""
    ctrl = make_controller(config, solver, device)
    model = ctrl.model
    ctrl.feedback(np.zeros(model.info.nx, np.float32))
    ready = {"ready": True, "config": config, "nx": model.info.nx,
             "nu": model.info.nu, "N": ctrl.N, "device": str(ctrl.device)}
    return ctrl, ready


def _arr(req, key):
    v = req.get(key)
    return None if v is None else np.asarray(v, np.float32)


def _parse_arrays(req):
    x = _arr(req, "x")
    if x is None:
        raise ValueError('request needs "x"')
    return x, _arr(req, "omega"), _arr(req, "price"), _arr(req, "u_prev")


def solve_request(ctrl, req) -> dict:
    """Solve one request dict → response dict (no 'id' echo). A 2-D "x"
    is a client-batched request: one ``feedback_batch`` call, list-valued
    reply."""
    x, W, Pq, up = _parse_arrays(req)
    t0 = time.perf_counter()
    if x.ndim == 2:
        sol = ctrl.feedback_batch(x, omega_forecasts=W, price_seq=Pq,
                                  u_prevs=up)
        resp = {"u": sol.u.tolist(), "delta": sol.delta.tolist(),
                "obj": sol.obj.tolist(), "found": sol.found.tolist(),
                "batch": int(x.shape[0])}
    else:
        sol = ctrl.feedback(x, omega_forecast=W, price_seq=Pq, u_prev=up)
        resp = {"u": sol.u.tolist(), "delta": sol.delta.tolist(),
                "obj": float(sol.obj), "found": bool(sol.found),
                "gap": float(sol.gap)}
    resp["ms"] = round(1e3 * (time.perf_counter() - t0), 3)
    return resp


def _coalesce_key(req):
    """Group key for cross-client coalescing: requests stack into one
    ``feedback_batch`` call iff their x is 1-D, their omega/u_prev shapes
    agree and price_seq — shared across the batch — is identical. None
    for a client-batched (2-D) request, which passes through."""
    x, W, Pq, up = _parse_arrays(req)
    if x.ndim not in (1, 2):
        raise ValueError(f"x must be 1-D or 2-D, got ndim={x.ndim}")
    if x.ndim != 1:
        return None
    price_key = None if Pq is None else (Pq.shape, Pq.tobytes())
    return (x.shape, None if W is None else W.shape,
            None if up is None else up.shape, price_key)


def _solve_group(ctrl, reqs):
    """Solve a same-key group of 1-D requests as ONE ``feedback_batch``
    call padded to the next power of two (with copies of the first
    request); returns one response dict per request."""
    parsed = [_parse_arrays(r) for r in reqs]
    B = len(parsed)
    Bp = 1
    while Bp < B:
        Bp *= 2

    def stack(i):
        if parsed[0][i] is None:
            return None
        return np.stack([p[i] for p in parsed] + [parsed[0][i]] * (Bp - B))

    t0 = time.perf_counter()
    sol = ctrl.feedback_batch(stack(0), omega_forecasts=stack(1),
                              price_seq=parsed[0][2], u_prevs=stack(3))
    u, delta = sol.u.tolist(), sol.delta.tolist()
    obj, found, gap = sol.obj.tolist(), sol.found.tolist(), sol.gap.tolist()
    ms = round(1e3 * (time.perf_counter() - t0), 3)
    return [{"u": u[i], "delta": delta[i], "obj": obj[i], "found": found[i],
             "gap": gap[i], "ms": ms, "coalesced": B} for i in range(B)]


class _TcpServer:
    """Threaded socket front: a reader thread per connection → one shared
    request queue → ONE solver thread (the card runs one request at a
    time). Writers take the connection's lock, so solver responses and
    reader-side errors interleave safely."""

    def __init__(self, ctrl, ready, host, port, window_ms, max_batch):
        self.ctrl = ctrl
        self.ready = ready
        self.window = window_ms / 1e3
        self.max_batch = max_batch
        self.q: queue.Queue = queue.Queue()
        self.stop = threading.Event()
        self.stats_lock = threading.Lock()
        self.stats = {"requests": 0, "errors": 0, "coalesced_batches": 0,
                      "max_coalesce": 1, "connections": 0,
                      "deadline_shed": 0}
        self.srv = socket.create_server((host, port))
        self.port = self.srv.getsockname()[1]

    @staticmethod
    def _send(conn_entry, obj):
        conn, lock = conn_entry
        data = (json.dumps(obj) + "\n").encode()
        try:
            with lock:
                conn.sendall(data)
        except OSError:
            pass                  # client went away; the solver keeps going

    def _reader(self, conn):
        entry = (conn, threading.Lock())
        with self.stats_lock:
            self.stats["connections"] += 1
        buf = b""
        try:
            while not self.stop.is_set():
                chunk = conn.recv(65536)
                if not chunk:
                    break
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if not line.strip():
                        continue
                    try:
                        req = json.loads(line)
                    except json.JSONDecodeError as e:
                        self._send(entry, {"error": f"bad json: {e}"})
                        continue
                    if not isinstance(req, dict):
                        self._send(entry, {"error": "request must be a "
                                                    "JSON object"})
                        continue
                    cmd = req.get("cmd")
                    if cmd == "ping":      # health: no device round-trip
                        self._send(entry, {"pong": True})
                        continue
                    if cmd == "stats":
                        with self.stats_lock:
                            self._send(entry, dict(self.stats))
                        continue
                    if cmd == "quit":
                        return
                    if cmd == "shutdown":
                        self._send(entry, {"bye": True})
                        self.stop.set()
                        self.q.put(None)   # wake the solver thread
                        return
                    self.q.put((entry, req, time.monotonic()))
        finally:
            try:
                conn.close()
            except OSError:
                pass

    @staticmethod
    def _deadline_s(req):
        """The request's ``deadline_ms`` in seconds, or None."""
        try:
            return float(req["deadline_ms"]) / 1e3
        except (KeyError, TypeError, ValueError):
            return None

    def _pull_close(self, item):
        """Window close time (monotonic) implied by a queued request's
        deadline, or None: the hold may spend at most HALF the deadline
        budget, the other half is reserved for the solve itself."""
        _, req, t_arr = item
        dl = self._deadline_s(req)
        return None if dl is None else t_arr + dl / 2

    def _drain(self):
        """Collect the next coalescing batch: block for the first
        request, then hold the window (or just drain) for followers. A
        queued request's deadline pulls the window closed earlier."""
        item = self.q.get()
        if item is None:
            return []
        batch = [item]
        deadline = time.monotonic() + self.window
        while True:
            close = self._pull_close(batch[-1])
            if close is not None:
                deadline = min(deadline, close)
            if len(batch) >= self.max_batch:
                break
            remaining = deadline - time.monotonic()
            try:
                nxt = (self.q.get(timeout=remaining) if remaining > 0
                       else self.q.get_nowait())
            except queue.Empty:
                break
            if nxt is None:
                break
            batch.append(nxt)
        return batch

    def _reply(self, entry, req, resp):
        if "id" in req:
            resp["id"] = req["id"]
        self._send(entry, resp)

    def _solver_loop(self):
        while not self.stop.is_set():
            batch = self._drain()
            # shed expired requests before touching the device
            now = time.monotonic()
            live = []
            for entry, req, t_arr in batch:
                dl = self._deadline_s(req)
                if dl is not None and now - t_arr > dl:
                    with self.stats_lock:
                        self.stats["deadline_shed"] += 1
                    self._reply(entry, req, {
                        "error": "deadline exceeded",
                        "deadline_exceeded": True,
                        "queued_ms": round(1e3 * (now - t_arr), 3)})
                else:
                    live.append((entry, req))
            # group coalescible requests by signature
            groups: dict = {}
            singles = []
            for entry, req in live:
                try:
                    key = _coalesce_key(req)
                except Exception as e:
                    self._reply(entry, req, self._err(e))
                    continue
                if key is None:
                    singles.append((entry, req))
                else:
                    groups.setdefault(key, []).append((entry, req))
            for members in groups.values():
                if len(members) == 1:
                    singles.extend(members)
                    continue
                try:
                    resps = _solve_group(self.ctrl, [r for _, r in members])
                except Exception:
                    # solve them one by one: one bad request must not
                    # poison its batch-mates
                    singles.extend(members)
                    continue
                with self.stats_lock:
                    self.stats["requests"] += len(members)
                    self.stats["coalesced_batches"] += 1
                    self.stats["max_coalesce"] = max(
                        self.stats["max_coalesce"], len(members))
                for (entry, req), resp in zip(members, resps):
                    self._reply(entry, req, resp)
            for entry, req in singles:
                try:
                    resp = solve_request(self.ctrl, req)
                    with self.stats_lock:
                        self.stats["requests"] += 1
                except Exception as e:
                    resp = self._err(e)
                self._reply(entry, req, resp)

    def _err(self, e):
        with self.stats_lock:
            self.stats["errors"] += 1
        return {"error": f"{type(e).__name__}: {e}"}

    def serve_forever(self, out=None):
        out = sys.stdout if out is None else out
        solver = threading.Thread(target=self._solver_loop, daemon=True)
        solver.start()
        self.srv.settimeout(0.25)
        out.write(json.dumps({**self.ready, "tcp_port": self.port}) + "\n")
        out.flush()
        try:
            while not self.stop.is_set():
                try:
                    conn, _ = self.srv.accept()
                except socket.timeout:
                    continue
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                threading.Thread(target=self._reader, args=(conn,),
                                 daemon=True).start()
        finally:
            self.srv.close()
            solver.join(timeout=5.0)


def stdin_loop(ctrl, ready, inp=None, out=None):
    """Serve line-delimited JSON from ``inp`` (default stdin) to ``out``
    (default stdout) until EOF or {"cmd": "quit"}."""
    inp = sys.stdin if inp is None else inp
    out = sys.stdout if out is None else out

    def emit(obj):
        out.write(json.dumps(obj) + "\n")
        out.flush()

    emit(ready)
    for line in inp:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError as e:
            emit({"error": f"bad json: {e}"})
            continue
        if not isinstance(req, dict):
            emit({"error": "request must be a JSON object"})
            continue
        if req.get("cmd") == "quit":
            break
        if req.get("cmd") == "ping":
            emit({"pong": True})
            continue
        try:
            resp = solve_request(ctrl, req)
        except Exception as e:  # keep serving on bad requests
            resp = {"error": f"{type(e).__name__}: {e}"}
        if "id" in req:
            resp["id"] = req["id"]
        emit(resp)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pyhybridcontrol_tpu_torch.serve")
    ap.add_argument("--config", required=True)
    ap.add_argument("--solver", default="bnb",
                    choices=["bnb", "enumerate", "stagewise"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tcp", type=int, default=None, metavar="PORT",
                    help="serve line-delimited JSON on a TCP socket (0 = "
                         "ephemeral; the chosen port is printed in the "
                         "ready line) with cross-client request coalescing")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--coalesce-window", type=float, default=2.0,
                    metavar="MS", help="hold a coalescing batch open this "
                    "long after its first request (TCP mode; 0 = batch "
                    "only what is already queued)")
    ap.add_argument("--max-batch", type=int, default=256,
                    help="coalescing batch cap (TCP mode)")
    args = ap.parse_args(argv)

    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("pyhybridcontrol_tpu_torch.serve: --device cuda but no "
                  "CUDA device is available (use --device cpu to serve on "
                  "the CPU)", file=sys.stderr)
            return 2
    ctrl, ready = build_controller(args.config, args.solver, args.device)
    if args.tcp is None:
        stdin_loop(ctrl, ready)
    else:
        _TcpServer(ctrl, ready, args.host, args.tcp, args.coalesce_window,
                   args.max_batch).serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
