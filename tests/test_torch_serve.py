"""Process-level surfaces of the port, driven as real subprocesses: the
serve loop on the CPU, its refusal to start on a missing card, the
guarantee that the port never imports JAX, and the kernel loader's
refusal to fall back when nvcc is absent."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

_repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = _repo + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    return env


def _cuda_available():
    import torch

    return torch.cuda.is_available()


def test_serve_loop_cpu():
    proc = subprocess.Popen(
        [sys.executable, "-m", "pyhybridcontrol_tpu_torch.serve",
         "--config", "double_integrator", "--device", "cpu"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=_env())
    try:
        def ask(line):
            proc.stdin.write(line + "\n")
            proc.stdin.flush()
            return json.loads(proc.stdout.readline())

        ready = json.loads(proc.stdout.readline())
        assert ready["ready"] and ready["nx"] == 2 and ready["N"] == 10
        assert ready["device"] == "cpu"
        assert ask('{"cmd": "ping"}') == {"pong": True}
        resp = ask(json.dumps({"x": [2.0, 0.0], "id": 7}))
        assert resp["found"] and len(resp["u"]) == 1 and resp["id"] == 7
        # config 1 at x0=[2,0] (same instance as chip_smoke.py's first state)
        assert abs(resp["obj"] - (-50.6868)) <= 1e-3
        assert np.isfinite(resp["gap"]) and resp["ms"] > 0
        assert "error" in ask("this is not json")
        batched = ask(json.dumps({"x": [[1.0, -0.5], [12.0, 0.0]]}))
        assert batched["batch"] == 2 and batched["found"] == [True, False]
        assert len(batched["u"]) == 2 and len(batched["obj"]) == 2
        assert "error" in ask(json.dumps({"x": [1.0, 2.0, 3.0]}))
        assert ask(json.dumps({"x": [12.0, 0.0]}))["found"] is False
        proc.stdin.write('{"cmd": "quit"}\n')
        proc.stdin.flush()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_serve_cuda_without_card_exits_nonzero():
    if _cuda_available():
        pytest.skip("a CUDA device is present: --device cuda would serve")
    out = subprocess.run(
        [sys.executable, "-m", "pyhybridcontrol_tpu_torch.serve",
         "--config", "double_integrator"],
        input='{"cmd": "quit"}\n', capture_output=True, text=True,
        env=_env(), timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert out.stdout == ""


def test_port_never_imports_jax():
    code = """
import importlib, pkgutil, sys
import pyhybridcontrol_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from pyhybridcontrol_tpu_torch.control.mpc import MpcController
from pyhybridcontrol_tpu_torch.models import (
    di_default_weights, switched_double_integrator)
r = MpcController(switched_double_integrator(), 4, di_default_weights(),
                  qp_iters=200, device="cpu").feedback([2.0, 0.0])
assert bool(r.found)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib",
                                            "pyhybridcontrol_tpu.")))
assert "jax" not in sys.modules and not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "ok"


def test_chip_smoke_refuses_without_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without a card,
    and alone in a directory without the package."""
    if _cuda_available():
        pytest.skip("a CUDA device is present")
    src = os.path.join(_repo, "chip_smoke.py")
    for cwd, script in ((_repo, src), (tmp_path, None)):
        if script is None:
            script = str(tmp_path / "chip_smoke.py")
            with open(src) as a, open(script, "w") as b:
                b.write(a.read())
        out = subprocess.run([sys.executable, script], capture_output=True,
                             text=True, cwd=cwd, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_profile_serve_busy_time_and_refusal_without_card():
    """The profiler's device-busy time is the union of the operations'
    intervals (overlaps counted once), and the profile refuses to run
    without a card."""
    from types import SimpleNamespace as NS

    from pyhybridcontrol_tpu_torch import profile_serve

    ev = [NS(time_range=NS(start=a, end=b))
          for a, b in ((5.0, 8.0), (0.0, 2.0), (1.0, 3.0), (6.0, 7.0))]
    assert profile_serve._busy_us(ev) == 6.0     # [0,3] ∪ [5,8]
    assert profile_serve._busy_us([]) == 0.0
    if not _cuda_available():
        assert profile_serve.main([]) == 1


def test_profile_reads_device_events_from_the_kineto_results():
    """The profile reads the device operations straight from the raw
    kineto results (not ``prof.events()``, which builds a FunctionEvent
    tree): the CUDA ones only, as (name, time range in µs)."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    from pyhybridcontrol_tpu_torch import profile_serve

    def ev(name, dev, a, b):
        return NS(name=lambda: name, device_type=lambda: dev,
                  start_ns=lambda: a, end_ns=lambda: b)

    raw = [ev("cudaLaunchKernel", DeviceType.CPU, 0, 9000),
           ev("sw_any_forward", DeviceType.CUDA, 1000, 4000),
           ev("sw_admm_kernel", DeviceType.CUDA, 3000, 5000)]
    prof = NS(profiler=NS(kineto_results=NS(events=lambda: raw)))
    got = profile_serve._device_events(prof)
    assert [(e.name, e.time_range.start, e.time_range.end) for e in got] == [
        ("sw_any_forward", 1.0, 4.0), ("sw_admm_kernel", 3.0, 5.0)]
    assert profile_serve._busy_us(got) == 4.0


def test_loader_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc → a clear error, never a silent CPU fallback."""
    from pyhybridcontrol_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOMES", (str(tmp_path),))
    for var in ("CUDA_HOME", "CUDA_PATH"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    assert _build.find_nvcc() is None
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library()
