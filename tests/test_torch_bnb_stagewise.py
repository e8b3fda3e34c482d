"""B&B over the port's stagewise O(N) frame (solver/bnb_stagewise.py), the
controller's stagewise solver and ``serve --solver stagewise``, against the
reference's tests/test_bnb_stagewise.py and tests/test_controller.py, on
the CPU.

The stagewise objective keeps the x0-dependent constant that the condensed
frame drops, so a plan of the condensed enumeration is held in the
stagewise frame (its states simulated in fp64, the objective evaluated
there): the same MIQP in another frame. Tolerances: binary sequences
equal; first inputs within 3e-2 (the reference's); objectives within 1e-3
(relative, floor 1) of the reference's stagewise B&B and of the condensed
enumeration's plan evaluated in the stagewise frame."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyhybridcontrol_tpu.models.double_integrator as jdi
import pyhybridcontrol_tpu_torch.models.double_integrator as tdi
from pyhybridcontrol_tpu.ops import stagewise as jsw
from pyhybridcontrol_tpu.solver import bnb_stagewise as jbs
from pyhybridcontrol_tpu.solver.bnb import BnbSpec as JSpec
from pyhybridcontrol_tpu_torch import convert
from pyhybridcontrol_tpu_torch.control.mpc import MpcController
from pyhybridcontrol_tpu_torch.ops import stagewise as tsw
from pyhybridcontrol_tpu_torch.ops.admm import prepare_admm_mpc
from pyhybridcontrol_tpu_torch.ops.condense import CondensedMpc
from pyhybridcontrol_tpu_torch.solver import bnb_stagewise as tbs
from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec
from pyhybridcontrol_tpu_torch.solver.enumerate import (
    solve_miqp_enumerate_device,
)

torch.set_num_threads(2)

_repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_repo, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stagewise_value(sw, q, model, x0, V):
    """The stagewise objective of a plan V (N, nv) in fp64, its states
    simulated from x0 (``chip_smoke.stagewise_value``, which phase 21
    holds the served stagewise objectives with)."""
    return _chip_smoke().stagewise_value(sw, q, model, x0, V)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(1.0, abs(float(b)))


def _enumerate(model, w, N, x0, iters=600):
    c = CondensedMpc(model, N, w)
    qp, admm = c.device_qp("cpu"), prepare_admm_mpc(c, device="cpu")
    f, h = qp.assemble(torch.as_tensor(x0))
    xV, obj, bits, _ = solve_miqp_enumerate_device(admm, qp, f, h,
                                                   iters=iters)
    return qp.full_v(xV).double().numpy(), bits.numpy()


def test_bnb_matches_condensed_enumeration_and_reference():
    """tests/test_bnb_stagewise.py's instance (N=8, x0=[2, 0]): the port's
    stagewise B&B finds the condensed enumeration's binary sequence and
    first input, its objective equals the enumeration plan's value in the
    stagewise frame and the reference's stagewise B&B objective."""
    N, x0 = 8, np.array([2.0, 0.0], np.float32)
    model, w = tdi.switched_double_integrator(), tdi.default_weights()
    sw = tsw.prepare_stagewise(model, N, w, device="cpu")
    q, l, u = tsw.assemble_stagewise(sw, torch.as_tensor(x0))
    spec = dict(capacity=256, wave_size=16, qp_iters=600, max_waves=48)
    r = tbs.solve_miqp_bnb_stagewise(sw, q, l, u, BnbSpec(**spec))
    assert bool(r.found)
    xi = r.x.reshape(N, sw.b).numpy()
    V, bits = _enumerate(model, w, N, x0)
    np.testing.assert_array_equal(np.round(xi[:, sw.binary_idx_v[0]]), bits)
    np.testing.assert_allclose(xi[0, 0], V[0, 0], atol=3e-2)
    assert _rel(r.obj, stagewise_value(sw, q, model, x0, V)) <= 1e-3

    js = jsw.prepare_stagewise(jdi.switched_double_integrator(), N,
                               jdi.default_weights())
    jq, jl, ju = jsw.assemble_stagewise(js, jnp.asarray(x0))
    jr = jbs.solve_miqp_bnb_stagewise(js, jq, jl, ju, JSpec(**spec))
    assert bool(jr.found)
    assert _rel(r.obj, jr.obj) <= 1e-3


def test_backend_binary_idx_follows_blocking_leaders():
    """Blocked binary inputs branch at block leaders only, unblocked
    binaries (δ) at every stage: the reference backend's set."""
    N, groups = 8, [0, 0, 1, 1, 1, 2, 3, 3]
    for block_deltas in (False, True):
        js = jsw.prepare_stagewise(jdi.switched_double_integrator(), N,
                                   jdi.default_weights(), blocking=groups,
                                   block_deltas=block_deltas)
        ts = convert.stagewise_qp(js, "cpu")
        ref = jbs.StagewiseBackend(js).binary_idx
        got = tbs.StagewiseBackend(ts).binary_idx
        assert got == ref
        own = tsw.prepare_stagewise(tdi.switched_double_integrator(), N,
                                    tdi.default_weights(), blocking=groups,
                                    block_deltas=block_deltas, device="cpu")
        assert tbs.StagewiseBackend(own).binary_idx == ref
    assert len(tbs.StagewiseBackend(ts).binary_idx) == 4      # δ tied too


def test_backend_carries_the_extra_rows_in_opaque_warm_vectors():
    """With horizon-coupled rows the warm z/y carry the n_ext tail after the
    stage rows; a warm-started backend solve equals the reference's, and
    its certified node bound too."""
    N = 6
    A_v = np.zeros((1, N * 3))
    A_v[0, 0::3] = 1.0
    js = jsw.prepare_stagewise(jdi.switched_double_integrator(), N,
                               jdi.default_weights(),
                               extra=(A_v, np.array([-1.0])))
    ts = convert.stagewise_qp(js, "cpu")
    x0 = np.array([1.5, 0.5], np.float32)
    jq, jl, ju = jsw.assemble_stagewise(js, jnp.asarray(x0))
    je = jsw.assemble_stagewise_ext(js, jnp.asarray(x0))
    tq, tl, tu = tsw.assemble_stagewise(ts, torch.as_tensor(x0))
    te = tsw.assemble_stagewise_ext(ts, torch.as_tensor(x0))
    jb = jbs.StagewiseBackend(js, ext_u=je)
    tb = tbs.StagewiseBackend(ts, ext_u=te)
    assert tb.warm_size == jb.warm_size == N * ts.m_k + 1
    jf, jh = jbs.pack_stagewise_data(jq, jl, ju)
    tf, th = tbs.pack_stagewise_data(tq, tl, tu)
    W = 3
    jf, jh = jb.broadcast_data(jf, jh, W)
    tf, th = tb.broadcast_data(tf, th, W)
    lb = np.broadcast_to(np.asarray(js.lb_xi).reshape(-1), (W, tb.n)).copy()
    ub = np.broadcast_to(np.asarray(js.ub_xi).reshape(-1), (W, tb.n)).copy()
    bidx = list(tb.binary_idx)
    lb[1, bidx[:3]] = ub[1, bidx[:3]] = 1.0
    lb[2, bidx[::2]] = ub[2, bidx[::2]] = 0.0
    j1 = jb.solve(jf, jh, jnp.asarray(lb), jnp.asarray(ub), 100)
    j2 = jb.solve(jf, jh, jnp.asarray(lb), jnp.asarray(ub), 50,
                  warm=(j1.x, j1.z, j1.y))
    tw = tuple(torch.as_tensor(np.array(a)) for a in (j1.x, j1.z, j1.y))
    assert tw[1].shape == (W, tb.warm_size)
    t2 = tb.solve(tf, th, torch.as_tensor(lb), torch.as_tensor(ub), 50,
                  warm=tw)
    assert t2.z.shape == (W, tb.warm_size)
    for k in ("obj", "x", "z", "y"):
        want = np.asarray(getattr(j2, k), np.float64)
        got = getattr(t2, k).numpy()
        assert np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))) \
            <= 1e-3, k
    jn = jb.node_bound(j2, jf, jh, jnp.asarray(lb), jnp.asarray(ub))
    tn = tb.node_bound(t2, tf, th, torch.as_tensor(lb), torch.as_tensor(ub))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.slow
def test_hull_model_matches_condensed_and_reference():
    """The hull PWA encoding (stage-local) through the stagewise backend:
    the condensed B&B's binary sequence and first input
    (tests/test_bnb_stagewise.py), and the reference's stagewise
    objective."""
    from pyhybridcontrol_tpu.models.pwa_examples import (
        pwa_spring_mld as jpwa, pwa_weights as jpw)
    from pyhybridcontrol_tpu_torch.models.pwa_examples import (
        pwa_spring_mld, pwa_weights)
    from pyhybridcontrol_tpu_torch.solver.bnb import solve_miqp_bnb
    from pyhybridcontrol_tpu_torch.solver.repair import (
        prepare_repair, root_repair_incumbent)

    N, x0 = 6, np.array([1.5, 0.0], np.float32)
    spec = dict(capacity=512, wave_size=32, qp_iters=400, probe_iters=2000,
                max_waves=32, gap=1e-3)
    model, w = pwa_spring_mld(on_off=True, formulation="hull"), pwa_weights()
    sw = tsw.prepare_stagewise(model, N, w, device="cpu")
    q, l, u = tsw.assemble_stagewise(sw, torch.as_tensor(x0))
    r_sw = tbs.solve_miqp_bnb_stagewise(sw, q, l, u, BnbSpec(**spec))

    c = CondensedMpc(model, N, w)
    qp, admm = c.device_qp("cpu"), prepare_admm_mpc(c, device="cpu")
    probe = prepare_admm_mpc(c, rho=10.0, device="cpu")
    f, h = qp.assemble(torch.as_tensor(x0))
    seed = root_repair_incumbent(admm, qp, prepare_repair(model, w,
                                                          device="cpu"),
                                 torch.as_tensor(x0), f, h, qp_iters=400)
    r_c = solve_miqp_bnb(admm, qp, f, h, BnbSpec(**spec),
                         init_incumbent=seed, admm_probe=probe)
    assert bool(r_sw.found) and bool(r_c.found)
    xi = r_sw.x.reshape(N, sw.b).numpy()
    v_c = qp.full_v(r_c.x).numpy()
    bi = list(sw.binary_idx_v)
    np.testing.assert_array_equal(np.round(xi[:, bi]), np.round(v_c[:, bi]))
    np.testing.assert_allclose(xi[0, 0], v_c[0, 0], atol=3e-2)

    js = jsw.prepare_stagewise(jpwa(on_off=True, formulation="hull"), N,
                               jpw())
    jr = jbs.solve_miqp_bnb_stagewise(
        js, *jsw.assemble_stagewise(js, jnp.asarray(x0)), JSpec(**spec))
    assert _rel(r_sw.obj, jr.obj) <= 1e-3


# ---- the controller's stagewise solver and serve --------------------------


def test_controller_stagewise_feedback_and_batch():
    """tests/test_controller.py:93-117 and :171-181 on the port:
    solver="stagewise" returns v_seq/x_seq, builds with move blocking and
    horizon-coupled rows (the bordered path), and ``feedback_batch`` runs
    the vmap engine, whose instances equal ``feedback``; the reference's
    controller gives the same objectives."""
    from pyhybridcontrol_tpu.control.mpc import MpcController as JController

    model, w = tdi.switched_double_integrator(), tdi.default_weights()
    spec = dict(capacity=128, wave_size=8, qp_iters=300, max_waves=16)
    ctrl = MpcController(model, 12, w, solver="stagewise",
                         bnb_spec=BnbSpec(**spec), device="cpu")
    x0s = np.random.default_rng(7).normal(size=(3, 2)).astype(np.float32)
    batch = ctrl.feedback_batch(x0s)
    assert batch.u.shape == (3, 1) and bool(batch.found.all())
    assert batch.v_seq.shape == (3, 12, 3) and batch.x_seq.shape == (3, 12, 2)
    single = ctrl.feedback(x0s[0])
    np.testing.assert_allclose(batch.obj[0].numpy(), single.obj.numpy(),
                               rtol=1e-4, atol=1e-5)
    assert float(single.gap) >= 0.0
    jc = JController(jdi.switched_double_integrator(), 12,
                     jdi.default_weights(), solver="stagewise",
                     bnb_spec=JSpec(**spec))
    for i in range(3):
        assert _rel(batch.obj[i], jc.feedback(jnp.asarray(x0s[i])).obj) \
            <= 1e-3
    with pytest.raises(ValueError):
        ctrl.feedback_batch(x0s, engine="pooled")

    c2 = MpcController(model, 10, w, solver="stagewise", device="cpu")
    c2.set_move_blocking([k // 2 for k in range(10)])
    assert c2.stagewise.n_blk == 1
    c3 = MpcController(model, 10, w, solver="stagewise", device="cpu")
    c3.set_extra_constraints(np.zeros((1, 10 * model.info.nv)), np.ones(1))
    assert c3.stagewise.n_ext == 1 and c3._sw_probe.n_ext == 1
    first = c3.stagewise
    assert c3.stagewise is first           # built once per version
    c3.set_std_obj_weights(Ru=0.5)         # a new version rebuilds
    assert c3.stagewise is not first and c3.stagewise.n_ext == 1


def test_controller_stagewise_transforms_match_reference():
    """Soft rows, move blocking, a terminal set and an input budget at once,
    with a disturbance forecast, prices and u_prev: objective and first
    input against the reference's stagewise controller."""
    from pyhybridcontrol_tpu.control.mpc import MpcController as JController

    N = 8
    spec = dict(capacity=128, wave_size=16, qp_iters=300, max_waves=24,
                probe_iters=600)
    A_v = np.zeros((1, N * 3))
    A_v[0, 0::3] = 1.0
    out = []
    for pkg, ctor, mdl, wts, bs in (
            ("jax", JController, jdi.switched_double_integrator(),
             jdi.default_weights(), JSpec),
            ("torch", MpcController, tdi.switched_double_integrator(),
             tdi.default_weights(), BnbSpec)):
        kw = {} if pkg == "jax" else dict(device="cpu")
        ctrl = ctor(mdl, N, wts, solver="stagewise", bnb_spec=bs(**spec),
                    **kw)
        ctrl.set_soft_constraints([1, 9], lin_pen=5.0, quad_pen=1.0)
        ctrl.set_move_blocking([0, 0, 1, 1, 2, 2, 3, 3])
        ctrl.set_terminal_constraint(np.array([[1.0, 0.0]]),
                                     np.array([1.0]))
        ctrl.set_extra_constraints(A_v, np.array([-0.5]))
        prices = np.zeros((N, 3), np.float32)
        prices[:, 0] = 0.1
        x0 = np.array([1.0, -0.5], np.float32)
        sol = ctrl.feedback(x0 if pkg == "torch" else jnp.asarray(x0),
                            price_seq=prices, u_prev=np.array([0.2]))
        out.append(sol)
    ref, got = out
    assert bool(ref.found) and bool(got.found)
    assert _rel(got.obj, ref.obj) <= 1e-3
    np.testing.assert_allclose(got.u.numpy(), np.asarray(ref.u), atol=3e-2)


def test_serve_stagewise_cpu():
    """``serve --solver stagewise --device cpu`` answers a ping and two
    states: [2, 0] with the condensed enumeration's plan valued in the
    stagewise frame, and an out-of-box state with found=false."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _repo + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    proc = subprocess.Popen(
        [sys.executable, "-m", "pyhybridcontrol_tpu_torch.serve",
         "--config", "double_integrator", "--solver", "stagewise",
         "--device", "cpu"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    try:
        def ask(line):
            proc.stdin.write(line + "\n")
            proc.stdin.flush()
            return json.loads(proc.stdout.readline())

        ready = json.loads(proc.stdout.readline())
        assert ready["ready"] and ready["N"] == 10
        assert ask('{"cmd": "ping"}') == {"pong": True}
        resp = ask(json.dumps({"x": [2.0, 0.0]}))
        assert ask(json.dumps({"x": [12.0, 0.0]}))["found"] is False
        proc.stdin.write('{"cmd": "quit"}\n')
        proc.stdin.flush()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    from pyhybridcontrol_tpu_torch.configs import get_config

    cfg = get_config("double_integrator")
    model, ckw = cfg.build()
    x0 = np.array([2.0, 0.0], np.float32)
    sw = tsw.prepare_stagewise(model, cfg.N, ckw["weights"], device="cpu")
    q, _, _ = tsw.assemble_stagewise(sw, torch.as_tensor(x0))
    V, _ = _enumerate(model, ckw["weights"], cfg.N, x0)
    assert resp["found"] and np.isfinite(resp["gap"])
    assert _rel(resp["obj"], stagewise_value(sw, q, model, x0, V)) <= 1e-3
