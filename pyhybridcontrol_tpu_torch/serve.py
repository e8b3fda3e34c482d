"""Real-time controller serving loop on the card:

    python -m pyhybridcontrol_tpu_torch.serve --config double_integrator

Counterpart of ``pyhybridcontrol_tpu/serve.py`` (stdin mode). One JSON
request per line on stdin, one JSON response per line on stdout. The
controller is built once on ``--device`` (default ``cuda``; without a
card the server exits non-zero, it never carries on on the CPU).

Request:  {"x": [..nx..], "omega": [[..]] (N,nω) opt, "price": [[..]] opt,
           "u_prev": [..] opt, "id": any opt (echoed back)}
Response: {"u": [..], "delta": [..], "obj": f, "found": b, "gap": f,
           "ms": f}
Send {"cmd": "ping"} for a health check and {"cmd": "quit"} to stop.
A 2-D "x" (batched request) gets an error reply: batched requests wait
for the pooled engine, as does ``--tcp``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def build_controller(config: str, solver: str = "bnb", device="cuda"):
    """Build the controller of ``config`` on ``device`` and run one warmup
    solve (kernel build and first launch). Returns (ctrl, ready line)."""
    from pyhybridcontrol_tpu_torch.configs import get_config
    from pyhybridcontrol_tpu_torch.control.mpc import MpcController

    cfg = get_config(config)
    model, ckw = cfg.build()
    ctrl = MpcController(model, cfg.N, solver=solver, bnb_spec=cfg.bnb,
                         qp_iters=cfg.bnb.qp_iters, device=device, **ckw)
    ctrl.build()
    ctrl.feedback(np.zeros(model.info.nx, np.float32))
    ready = {"ready": True, "config": cfg.name, "nx": model.info.nx,
             "nu": model.info.nu, "N": cfg.N, "device": str(ctrl.device)}
    return ctrl, ready


def _arr(req, key):
    v = req.get(key)
    return None if v is None else np.asarray(v, np.float32)


def solve_request(ctrl, req) -> dict:
    """Solve one request dict → response dict (no 'id' echo)."""
    x = _arr(req, "x")
    if x is None:
        raise ValueError('request needs "x"')
    if x.ndim == 2:
        raise ValueError("batched requests (2-D x) wait for the pooled "
                         "engine, which is not ported yet")
    t0 = time.perf_counter()
    sol = ctrl.feedback(x, omega_forecast=_arr(req, "omega"),
                        price_seq=_arr(req, "price"),
                        u_prev=_arr(req, "u_prev"))
    resp = {"u": sol.u.tolist(), "delta": sol.delta.tolist(),
            "obj": float(sol.obj), "found": bool(sol.found),
            "gap": float(sol.gap)}
    resp["ms"] = round(1e3 * (time.perf_counter() - t0), 3)
    return resp


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
    ap.add_argument("--solver", default="bnb", choices=["bnb", "enumerate"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("pyhybridcontrol_tpu_torch.serve: --device cuda but no "
                  "CUDA device is available (use --device cpu to serve on "
                  "the CPU)", file=sys.stderr)
            return 2
    ctrl, ready = build_controller(args.config, args.solver, args.device)
    stdin_loop(ctrl, ready)
    return 0


if __name__ == "__main__":
    sys.exit(main())
