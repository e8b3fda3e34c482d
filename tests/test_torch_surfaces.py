"""The port's user-facing surfaces against the reference's on the CPU:
``io/`` (checkpoint, structured log, profile resampling),
``utils/profiling.py``, the ``run`` CLI (``main(argv)`` and
``run_study``) and the five examples.

Tolerances: the JSONL records and the resampled profiles are numpy
arithmetic on the same inputs, held exactly. The CLI's closed loops are
fp32 ADMM in another summation order: ``total_cost`` within rtol 1e-3 of
the reference's ``run.main`` (B&B: objectives only, never node counts);
a chunked study within rtol 1e-4 of the unchunked one (the reference
test's own bound, tests/test_cli.py); the batched run's per-instance
objectives within rtol and atol 1e-3 of the reference's vmapped run (the
bound of tests/test_bnb_pooled.py::test_pooled_matches_vmapped), since
the port pools the instances into one search."""

import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyhybridcontrol_tpu.configs import get_config as jget_config
from pyhybridcontrol_tpu.control.mpc import MpcController as JController
from pyhybridcontrol_tpu.io import logging as jlogging
from pyhybridcontrol_tpu.io import timeseries as jts
from pyhybridcontrol_tpu.loop import closed_loop as jclosed_loop
from pyhybridcontrol_tpu.loop import make_mpc_step as jmake_step
from pyhybridcontrol_tpu.loop.closed_loop import (
    ClosedLoopResult as JResult,
)
from pyhybridcontrol_tpu_torch import run
from pyhybridcontrol_tpu_torch.io import (
    StructuredLog,
    load_checkpoint,
    profile_to_dataframe,
    resample_profile,
    save_checkpoint,
)
from pyhybridcontrol_tpu_torch.loop import ClosedLoopResult
from pyhybridcontrol_tpu_torch.utils import profiling

torch.set_num_threads(2)


def _ref_main(argv):
    """The reference's ``run.main`` in process; its JSON line."""
    from pyhybridcontrol_tpu import run as jrun

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jrun.main(argv + ["--cpu"])
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _port_main(argv, capsys):
    rc = run.main(argv + ["--device", "cpu"])
    out = capsys.readouterr()
    assert rc == 0, out.err
    return json.loads(out.out.strip().splitlines()[-1])


def _result(rng, T=4, nx=2, nv=3, ny=2, n=30):
    return dict(xs=rng.normal(size=(T + 1, nx)).astype(np.float32),
                vs=rng.normal(size=(T, nv)).astype(np.float32),
                ys=rng.normal(size=(T, ny)).astype(np.float32),
                objs=rng.normal(size=T).astype(np.float32),
                found=rng.uniform(size=T) < 0.7,
                nodes=rng.integers(0, 50, size=T),
                plan=rng.normal(size=n).astype(np.float32),
                plan_ok=np.asarray(True))


# ---- io/checkpoint.py -------------------------------------------------------

def _state(kind, rng):
    if kind == "nested":
        return {"x": torch.arange(5.0), "k": torch.tensor(3),
                "nested": {"m": torch.eye(2), "b": torch.tensor([True])},
                "seq": [torch.ones(2, 3), (torch.zeros(1),)]}
    if kind == "result":
        return ClosedLoopResult(**{k: torch.as_tensor(v) for k, v in
                                   _result(rng).items()})
    return {"step": 7, "rate": 0.25, "flag": False,
            "arr": np.arange(3.0)}


@pytest.mark.parametrize("kind", ["nested", "result", "scalars"])
def test_checkpoint_round_trip(tmp_path, kind):
    """A nest of tensors, a ClosedLoopResult and plain scalars come back
    leaf for leaf, in the target's structure and leaf kind."""
    rng = np.random.default_rng(0)
    state = _state(kind, rng)
    p = str(tmp_path / "ck.bin")
    assert save_checkpoint(p, state, step=7, metadata={"cfg": kind}) == p
    blank = _state(kind, np.random.default_rng(1))
    got, step, meta = load_checkpoint(p, blank)
    assert step == 7 and meta == {"cfg": kind}
    assert type(got) is type(state)
    from pyhybridcontrol_tpu_torch.io.checkpoint import tree_leaves

    for a, b in zip(tree_leaves(got), tree_leaves(state), strict=True):
        assert type(a) is type(b)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype
    leaves, step, _ = load_checkpoint(p)       # inspection mode
    assert step == 7 and len(leaves) == len(tree_leaves(state))
    with pytest.raises(ValueError, match="structure mismatch"):
        load_checkpoint(p, {"only": torch.zeros(1)})


def test_checkpoint_atomic_overwrite(tmp_path, monkeypatch):
    """An overwrite replaces the file whole; a write that fails leaves
    the old file whole and no temporary file behind."""
    import os

    p = str(tmp_path / "ck.bin")
    save_checkpoint(p, {"a": torch.zeros(3)}, step=1)
    save_checkpoint(p, {"a": torch.ones(3)}, step=2)
    got, step, _ = load_checkpoint(p, {"a": torch.zeros(3)})
    assert step == 2 and got["a"].tolist() == [1.0, 1.0, 1.0]

    def fail(src, dst):
        raise OSError("disk full")

    monkeypatch.setattr(os, "replace", fail)
    with pytest.raises(OSError, match="disk full"):
        save_checkpoint(p, {"a": torch.full((3,), 5.0)}, step=3)
    monkeypatch.undo()
    got, step, _ = load_checkpoint(p, {"a": torch.zeros(3)})
    assert step == 2 and got["a"].tolist() == [1.0, 1.0, 1.0]
    assert os.listdir(tmp_path) == ["ck.bin"]


# ---- io/logging.py ----------------------------------------------------------

def test_structured_log_matches_reference(tmp_path):
    """The same closed-loop result gives the reference's JSONL records,
    field for field (all but the wall-clock ``t``)."""
    arrs = _result(np.random.default_rng(3), T=5)
    ref = JResult(**{k: jnp.asarray(v) for k, v in arrs.items()})
    port = ClosedLoopResult(**{k: torch.as_tensor(v)
                               for k, v in arrs.items()})
    recs = {}
    for name, cls, res in (("ref", jlogging.StructuredLog, ref),
                           ("port", StructuredLog, port)):
        p = str(tmp_path / f"{name}.jsonl")
        log = cls(p, run_name="study")
        log.log_closed_loop(res, every=2)
        log.log(9, cost=np.float32(1.5), x=np.array([1.0, 2.0]))
        log.close()
        recs[name] = [json.loads(line) for line in open(p)]
        for r in recs[name]:
            assert r.pop("t") > 0
    assert recs["port"] == recs["ref"]
    assert [r["step"] for r in recs["port"]] == [0, 2, 4, 9]


# ---- io/timeseries.py -------------------------------------------------------

def _profiles():
    import pandas as pd

    t = np.arange(0, 3600, 60.0)
    v = np.sin(t / 500.0) + 2.0
    s = pd.Series([0.0, 1.0, 2.0],
                  index=pd.date_range("2020-01-01", periods=3, freq="900s"))
    return [(s, dict(Ts=60.0)),
            ((np.array([0.0, 3600.0]), np.array([0.10, 0.30])),
             dict(Ts=900.0, T=6, how="hold")),
            ((t, v), dict(Ts=900.0, T=4, how="mean")),
            ((t, v), dict(Ts=450.0, how="interp")),
            (np.array([1.0, 2.0, 3.0]), dict(Ts=60.0))]


@pytest.mark.parametrize("case", range(5))
def test_resample_profile_matches_reference(case):
    """Every mode (interp, hold, mean; a Series, (t, v) arrays, a plain
    array passed through) equals the reference exactly: numpy on the same
    inputs."""
    series, kw = _profiles()[case]
    np.testing.assert_array_equal(resample_profile(series, **kw),
                                  jts.resample_profile(series, **kw))


def test_resample_unknown_mode_raises_and_dataframe_round_trip():
    for fn in (resample_profile, jts.resample_profile):
        with pytest.raises(ValueError, match="nearest"):
            fn((np.arange(3.0), np.arange(3.0)), Ts=1.0, how="nearest")
    v = np.array([1.0, 2.0, 3.0])
    s = profile_to_dataframe(v, Ts=60.0, name="tariff")
    ref = jts.profile_to_dataframe(v, Ts=60.0, name="tariff")
    assert s.equals(ref) and s.name == "tariff"
    np.testing.assert_allclose(resample_profile(s, Ts=60.0), v)


# ---- utils/profiling.py -----------------------------------------------------

def test_profiling_helpers(tmp_path, capsys):
    """wall_timer times and labels a block (no device to wait for on the
    CPU); trace writes a Chrome trace; bnb_stats gives the counter set of
    a B&B result, as the reference's does."""
    from pyhybridcontrol_tpu_torch.models.double_integrator import (
        default_weights, switched_double_integrator)
    from pyhybridcontrol_tpu_torch.ops import CondensedMpc, prepare_admm_mpc
    from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec, solve_miqp_bnb

    with profiling.wall_timer("block", sync=torch.device("cpu")) as t:
        torch.ones(8).sum()
    assert t["seconds"] >= 0 and "[block]" in capsys.readouterr().out
    c = CondensedMpc(switched_double_integrator(), 4, default_weights())
    qp, admm = c.device_qp("cpu"), prepare_admm_mpc(c, device="cpu")
    f, h = qp.assemble(torch.tensor([2.0, 0.0]))
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.wall_timer(sync={"f": f}) as t2:
            qp.assemble(torch.ones(8, 2))
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert len(prof.key_averages()) > 0 and t2["seconds"] > 0
    r = solve_miqp_bnb(admm, qp, f, h,
                       BnbSpec(capacity=64, wave_size=16, qp_iters=200))
    st = profiling.bnb_stats(r)
    assert set(st) == {"obj", "found", "waves", "nodes_solved", "overflow",
                       "bound_gap"}
    assert st["found"] and st["obj"] == float(r.obj)
    assert st["bound_gap"] >= -1e-6


# ---- run.py -----------------------------------------------------------------

@pytest.mark.parametrize("solver", ["enumerate", "bnb"])
def test_run_matches_reference(solver, capsys):
    """Config 1, 3 steps, against the reference's run.main: total_cost
    within rtol 1e-3, found_frac equal; mean_nodes equal for enumeration
    (B&B searches in another order: never node counts)."""
    argv = ["--config", "double_integrator", "--steps", "3",
            "--solver", solver]
    ref = _ref_main(argv)
    got = _port_main(argv, capsys)
    assert set(ref) <= set(got)
    assert got["config"] == "double_integrator" and got["steps"] == 3
    assert got["found_frac"] == ref["found_frac"] == 1.0
    np.testing.assert_allclose(got["total_cost"], ref["total_cost"],
                               rtol=1e-3)
    if solver == "enumerate":
        assert got["mean_nodes"] == ref["mean_nodes"] == 0.0


def test_run_chunked_checkpoint_and_resume(tmp_path, capsys):
    """A study in chunks of 2 with snapshots ends where the unchunked one
    does (rtol 1e-4); --resume extends it to 8 steps from step 6; a
    finished study resumed again is a no-op."""
    ckpt = str(tmp_path / "study.ckpt")
    base = ["--config", "double_integrator", "--solver", "enumerate"]
    plain = _port_main(base + ["--steps", "6"], capsys)
    chunk = ["--checkpoint", ckpt, "--checkpoint-every", "2"]
    got = _port_main(base + ["--steps", "6"] + chunk, capsys)
    assert got["resumed_from"] == 0 and got["steps"] == 6
    np.testing.assert_allclose(got["total_cost"], plain["total_cost"],
                               rtol=1e-4)
    state, step, meta = load_checkpoint(ckpt)
    assert step == 6 and meta == {"config": "double_integrator", "T": 6}
    assert len(state) == 4          # plan, plan_ok, u_prev, x (key order)
    got2 = _port_main(base + ["--steps", "8", "--resume"] + chunk, capsys)
    assert got2["resumed_from"] == 6 and got2["steps"] == 2
    assert np.isfinite(got2["total_cost"]) and got2["found_frac"] == 1.0
    again = _port_main(base + ["--steps", "8", "--resume"] + chunk, capsys)
    assert again["steps"] == 0 and again["resumed_from"] == 8


def test_run_log_and_result_checkpoint(tmp_path, capsys):
    """--log writes one JSONL record a step, read back; --checkpoint
    (without --checkpoint-every) writes the result, loadable into a
    ClosedLoopResult."""
    log, ckpt = tmp_path / "run.jsonl", tmp_path / "run.ckpt"
    got = _port_main(["--config", "double_integrator", "--steps", "2",
                      "--solver", "enumerate", "--log", str(log),
                      "--checkpoint", str(ckpt)], capsys)
    recs = [json.loads(line) for line in open(log)]
    assert [r["step"] for r in recs] == [0, 1]
    assert all(r["run"] == "double_integrator" and r["found"]
               for r in recs)
    np.testing.assert_allclose(sum(r["obj"] for r in recs),
                               got["total_cost"], rtol=1e-6)
    blank = ClosedLoopResult(**{f.name: torch.zeros(0)
                                for f in dataclasses.fields(
                                    ClosedLoopResult)})
    res, step, meta = load_checkpoint(str(ckpt), blank)
    assert step == 2 and meta == {"config": "double_integrator"}
    assert res.xs.shape == (3, 2) and bool(res.found.all())


def test_run_batch_matches_vmapped_reference(capsys):
    """--batch 4 of scenario_batch: one pooled search (global wave 4·16,
    pool 4·64) against the reference's vmapped closed loop on the same
    seeded states — per-instance objectives within rtol and atol 1e-3."""
    cfg = jget_config("scenario_batch")
    model, ckw = cfg.build()
    ctrl = JController(model, cfg.N, solver="bnb", bnb_spec=cfg.bnb,
                       qp_iters=cfg.bnb.qp_iters, **ckw).build()
    step = jmake_step(model, ctrl.device_qp, ctrl.admm, method="bnb",
                      bnb_spec=cfg.bnb, qp_iters=cfg.bnb.qp_iters,
                      repair=ctrl.repair, admm_probe=ctrl.admm_probe)
    rng = np.random.default_rng(0)
    rng.uniform(-2, 2, size=2)                 # the single-state draw
    x0s = rng.uniform(-2, 2, size=(4, 2)).astype(np.float32)
    ref = jax.jit(jax.vmap(lambda x: jclosed_loop(model, step, x, 1)))(
        jnp.asarray(x0s))
    metrics, res = run.run_study(run.parse_args(
        ["--config", "scenario_batch", "--batch", "4", "--device", "cpu"]))
    np.testing.assert_allclose(res.xs[0].numpy(), x0s)
    np.testing.assert_allclose(res.objs.numpy()[0],
                               np.asarray(ref.objs)[:, 0],
                               rtol=1e-3, atol=1e-3)
    assert metrics["found_frac"] == float(np.mean(np.asarray(ref.found)))
    assert (metrics["global_wave"], metrics["pool_slots"]) == (64, 256)
    # pool bytes: (P+1) rows of 8 meta + nb + n + 2·m_total node fp32,
    # m_total = m + n = 100 + 30 rows of the ADMM splitting
    assert metrics["pool_bytes"] == 4 * 257 * (8 + 10 + 30 + 2 * 130)
    got = _port_main(["--config", "scenario_batch", "--batch", "4",
                      "--solver", "enumerate"], capsys)
    assert got["batch"] == 4 and got["found_frac"] == 1.0


@pytest.mark.parametrize("argv", [
    ["--config", "thermal_uc", "--steps", "1"],
    ["--config", "sharded_bnb", "--batch", "2"],
])
def test_run_configs_on_the_cpu(argv, capsys):
    """Config 3 (move blocking, soft rows and the min-up rows) and config
    5 (N=20; a small batch here) run through ``main``."""
    got = _port_main(argv, capsys)
    assert got["found_frac"] == 1.0 and got["wall_s"] > 0


@pytest.mark.slow
def test_run_config2_on_the_cpu(capsys):
    """Config 2 (the PWA spring's hull frame, N=20, 60 binaries) for one
    step through ``main``: about 85 s on the CPU, so slow."""
    got = _port_main(["--config", "pwa_actuator", "--steps", "1"], capsys)
    assert got["found_frac"] == 1.0 and np.isfinite(got["total_cost"])


def test_run_refusals(capsys):
    """An unknown config exits non-zero and names it; --device cuda
    without a card exits non-zero (no fallback to the CPU)."""
    assert run.main(["--config", "definitely_not_a_config",
                     "--device", "cpu"]) != 0
    assert "definitely_not_a_config" in capsys.readouterr().err
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert run.main(["--config", "double_integrator"]) != 0
    assert "no CUDA device" in capsys.readouterr().err


# ---- examples ---------------------------------------------------------------

EXAMPLES = {
    "double_integrator_study": (["--steps", "2"], "all steps solved: True"),
    "dewh_dsm_study": (["--hours", "0.5"], "all MIQPs solved: True"),
    "micro_grid_study": (["--steps", "1", "--agents", "2"],
                         "agent 0 history"),
    "scenario_tree_study": (["--scenarios", "2", "--horizon", "3"],
                            "study ok: True"),
    "pwa_formulation_study": (["--N", "3", "--waves", "3"],
                              "hull <= bigm: True"),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs(name, capsys):
    """Each example's ``main`` at its smallest arguments on the CPU."""
    import importlib

    mod = importlib.import_module(
        f"pyhybridcontrol_tpu_torch.examples.{name}")
    args, marker = EXAMPLES[name]
    mod.main(args + ["--device", "cpu"])
    assert marker in capsys.readouterr().out
