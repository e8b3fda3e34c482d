"""The port's closed loop (pyhybridcontrol_tpu_torch/loop/closed_loop.py)
against the reference's on the CPU, at the N=6 double integrator of
tests/test_closed_loop.py: regulation and dynamics, B&B against
enumeration, the enumeration loop against the reference's and the
committed golden, a chunked study resumed with ``prev_plan``, the pooled
batched loop against per-instance loops, and ``feedback_batch`` with the
"vmap" engine.

Tolerances are the reference test's own: total cost rtol 2e-3 and states
1e-2 between B&B and enumeration (warm-started probes may evaluate a leaf
slightly better than cold enumeration, after which trajectories part on
near-ties); 1e-3 between the two packages' enumeration loops and against
the golden (same σ-form iteration in fp32, another summation order)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyhybridcontrol_tpu.models.double_integrator as jdi
import pyhybridcontrol_tpu_torch.models.double_integrator as tdi
from pyhybridcontrol_tpu.control.mpc import MpcController as JController
from pyhybridcontrol_tpu.loop import closed_loop as jclosed_loop
from pyhybridcontrol_tpu.loop import make_mpc_step as jmake_step
from pyhybridcontrol_tpu.ops.admm import prepare_admm_mpc as jprep
from pyhybridcontrol_tpu.ops.condense import CondensedMpc as JCondensed
from pyhybridcontrol_tpu.solver.bnb import BnbSpec as JSpec
from pyhybridcontrol_tpu_torch.control.mpc import MpcController
from pyhybridcontrol_tpu_torch.loop import (
    ClosedLoopResult,
    closed_loop,
    closed_loop_batch,
    make_mpc_step,
    make_mpc_step_batch,
)
from pyhybridcontrol_tpu_torch.ops.admm import prepare_admm_mpc
from pyhybridcontrol_tpu_torch.ops.condense import CondensedMpc
from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "double_integrator_N6_T10.npz")
X0 = [2.0, 0.0]


def _port(N):
    model = tdi.switched_double_integrator()
    c = CondensedMpc(model, N, tdi.default_weights())
    return (model, c.device_qp("cpu"), prepare_admm_mpc(c, device="cpu"),
            prepare_admm_mpc(c, rho=10.0, device="cpu"))


@pytest.fixture(scope="module")
def port():
    return _port(6)


@pytest.fixture(scope="module")
def ref():
    model = jdi.switched_double_integrator()
    c = JCondensed(model, 6, jdi.default_weights())
    return model, c.device_qp(), jprep(c)


@pytest.fixture(scope="module")
def enum_loop(port):
    model, qp, admm, _ = port
    step = make_mpc_step(model, qp, admm, method="enumerate", qp_iters=600)
    return closed_loop(model, step, X0, T=10)


def test_closed_loop_regulates_and_follows_the_dynamics(port, ref):
    model, qp, admm, _ = port
    step = make_mpc_step(model, qp, admm, method="bnb",
                         bnb_spec=BnbSpec(capacity=128, wave_size=16,
                                          qp_iters=400))
    assert step.carries_plan and step.n_dec == qp.n
    res = closed_loop(model, step, X0, T=10)
    assert isinstance(res, ClosedLoopResult)
    assert res.xs.shape == (11, 2) and res.vs.shape == (10, 3)
    assert res.ys.shape[0] == 10 and res.nodes.shape == (10,)
    assert bool(res.found.all()) and bool(res.plan_ok)
    assert res.plan.shape == (qp.n,)
    # regulation: the terminal state much closer to the origin
    assert float(res.xs[-1].norm()) < 0.3 * float(np.linalg.norm(X0))
    # dynamics: x_{k+1} = step_v(x_k, v_k), the reference's step_v too
    jmodel = ref[0]
    for k in [0, 4, 9]:
        want = model.step_v(res.xs[k], res.vs[k])
        np.testing.assert_allclose(res.xs[k + 1].numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-6)
        jwant = jmodel.step_v(jnp.asarray(res.xs[k].numpy()),
                              jnp.asarray(res.vs[k].numpy()))
        np.testing.assert_allclose(want.numpy(), np.asarray(jwant),
                                   rtol=1e-6, atol=1e-6)


def test_bnb_matches_enumeration_closed_loop(port, ref):
    """The port's B&B loop against its enumeration loop, and against the
    reference's B&B loop on the same spec."""
    model, qp, admm, _ = port
    spec = dict(capacity=256, wave_size=16, qp_iters=600)
    sb = make_mpc_step(model, qp, admm, method="bnb",
                       bnb_spec=BnbSpec(**spec))
    se = make_mpc_step(model, qp, admm, method="enumerate", qp_iters=600)
    rb = closed_loop(model, sb, X0, T=8)
    re = closed_loop(model, se, X0, T=8)
    assert not se.carries_plan and re.plan.shape == (0,)
    assert not bool(re.plan_ok) and not re.nodes.any()
    np.testing.assert_allclose(float(rb.objs.sum()), float(re.objs.sum()),
                               rtol=2e-3)
    np.testing.assert_allclose(rb.xs.numpy(), re.xs.numpy(), rtol=1e-2,
                               atol=1e-2)
    jmodel, jqp, jadmm = ref
    jstep = jmake_step(jmodel, jqp, jadmm, method="bnb",
                       bnb_spec=JSpec(**spec))
    jr = jclosed_loop(jmodel, jstep, jnp.asarray(X0), T=8)
    np.testing.assert_allclose(float(rb.objs.sum()),
                               float(np.sum(np.asarray(jr.objs))), rtol=2e-3)
    np.testing.assert_allclose(rb.xs.numpy(), np.asarray(jr.xs), rtol=1e-2,
                               atol=1e-2)


def test_enumeration_loop_matches_reference_and_golden(ref, enum_loop):
    jmodel, jqp, jadmm = ref
    jstep = jmake_step(jmodel, jqp, jadmm, method="enumerate", qp_iters=600)
    jr = jclosed_loop(jmodel, jstep, jnp.asarray(X0), T=10)
    np.testing.assert_allclose(enum_loop.xs.numpy(), np.asarray(jr.xs),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(enum_loop.vs.numpy(), np.asarray(jr.vs),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_array_equal(enum_loop.found.numpy(),
                                  np.asarray(jr.found))
    g = np.load(GOLDEN)
    np.testing.assert_allclose(enum_loop.xs.numpy(), g["xs"], rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(float(enum_loop.objs.sum()),
                               float(g["total_cost"]), rtol=1e-3)


def test_price_window_follows_reference(port, ref, rng):
    """A (T+N, nv) price trajectory: each step sees the N rows from its own
    time on, as the reference's dynamic slice gives them."""
    model, qp, admm, _ = port
    jmodel, jqp, jadmm = ref
    T = 4
    price = rng.normal(0.0, 2.0, size=(T + 6, 3)).astype(np.float32)
    step = make_mpc_step(model, qp, admm, method="enumerate", qp_iters=600)
    res = closed_loop(model, step, X0, T=T, price_traj=price)
    jstep = jmake_step(jmodel, jqp, jadmm, method="enumerate", qp_iters=600)
    jr = jclosed_loop(jmodel, jstep, jnp.asarray(X0), T=T,
                      price_traj=jnp.asarray(price))
    np.testing.assert_allclose(res.xs.numpy(), np.asarray(jr.xs), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(res.objs.numpy(), np.asarray(jr.objs),
                               rtol=1e-3, atol=1e-3)
    # the window moves: the same loop without prices differs
    plain = closed_loop(model, step, X0, T=T)
    assert not torch.allclose(plain.objs, res.objs, atol=1e-2)


def test_chunked_run_resumed_with_prev_plan_equals_the_whole_run(port):
    """A study cut in two chunks, the second seeded with the first's
    carried plan, state and last input, equals the uninterrupted run."""
    model, qp, admm, probe = port
    step = make_mpc_step(model, qp, admm, method="bnb", admm_probe=probe,
                         bnb_spec=BnbSpec(capacity=128, wave_size=16,
                                          qp_iters=200))
    whole = closed_loop(model, step, X0, T=6)
    first = closed_loop(model, step, X0, T=3)
    u_last = model.info.split_v(first.vs[-1])[0]
    second = closed_loop(model, step, first.xs[-1], T=3, u_prev0=u_last,
                         prev_plan=(first.plan, first.plan_ok))
    assert torch.equal(torch.cat([first.xs, second.xs[1:]]), whole.xs)
    assert torch.equal(torch.cat([first.objs, second.objs]), whole.objs)
    assert torch.equal(second.plan, whole.plan)
    # without the carried plan the second chunk starts from nothing
    cold = closed_loop(model, step, first.xs[-1], T=3, u_prev0=u_last)
    assert cold.found.all()


def test_closed_loop_batch_matches_per_instance_loops():
    """The pooled batched loop gives each instance the trajectory of its
    own loop: pooling changes the per-step schedule, never the
    per-instance search (the reference test's tolerances)."""
    model, qp, admm, probe = _port(4)
    B, T = 4, 3
    x0s = np.random.default_rng(5).normal(0, 1.2, (B, 2)).astype(np.float32)
    spec = BnbSpec(capacity=64, wave_size=64, max_waves=512, qp_iters=400,
                   probe_iters=400)
    step_b = make_mpc_step_batch(model, qp, admm, bnb_spec=spec,
                                 pool_slots=16 * B, admm_probe=probe)
    assert step_b.carries_plan
    rb = closed_loop_batch(model, step_b, x0s, T)
    assert rb.xs.shape == (T + 1, B, 2) and rb.vs.shape == (T, B, 3)
    assert rb.objs.shape == (T, B) and rb.nodes.shape == (T,)
    assert rb.plan.shape == (B, qp.n) and bool(rb.plan_ok.all())
    step1 = make_mpc_step(model, qp, admm, method="bnb", admm_probe=probe,
                          bnb_spec=BnbSpec(capacity=64, wave_size=16,
                                           max_waves=128, qp_iters=400,
                                           probe_iters=400))
    solo = [closed_loop(model, step1, x0s[i], T) for i in range(B)]
    assert bool(rb.found.all()) and all(bool(r.found.all()) for r in solo)
    np.testing.assert_allclose(
        rb.xs.permute(1, 0, 2).numpy(),
        torch.stack([r.xs for r in solo]).numpy(), atol=5e-3)
    np.testing.assert_allclose(
        rb.objs.T.numpy(), torch.stack([r.objs for r in solo]).numpy(),
        rtol=5e-3, atol=5e-3)


def test_feedback_batch_vmap_engine_is_feedback_per_instance():
    """engine="vmap" (and "auto" for the enumeration solver) is one
    ``feedback`` per instance, stacked; the enumeration controller agrees
    with the reference's vmap engine."""
    x0s = np.array([[2.0, 0.0], [-1.0, 0.5], [12.0, 0.0]], np.float32)
    en = MpcController(tdi.switched_double_integrator(), 4,
                       tdi.default_weights(), solver="enumerate",
                       qp_iters=400, device="cpu")
    got = en.feedback_batch(x0s)
    for i, x0 in enumerate(x0s):
        one = en.feedback(x0)
        for k in ("u", "delta", "obj", "found", "v_seq"):
            assert torch.equal(got[k][i], one[k]), k
    assert got.u.shape == (3, 1) and got.found.tolist() == [True, True,
                                                            False]
    jc = JController(jdi.switched_double_integrator(), 4,
                     jdi.default_weights(), solver="enumerate", qp_iters=400)
    jr = jc.feedback_batch(jnp.asarray(x0s), engine="vmap")
    np.testing.assert_array_equal(got.found.numpy(), np.asarray(jr.found))
    ok = got.found.numpy()
    np.testing.assert_allclose(got.obj.numpy()[ok], np.asarray(jr.obj)[ok],
                               rtol=1e-3, atol=1e-3)
    bnb = MpcController(tdi.switched_double_integrator(), 4,
                        tdi.default_weights(), device="cpu",
                        bnb_spec=BnbSpec(capacity=64, wave_size=16,
                                         qp_iters=200))
    got = bnb.feedback_batch(x0s[:2], engine="vmap")
    for i in range(2):
        assert torch.equal(got.obj[i], bnb.feedback(x0s[i]).obj)


def test_step_options_the_port_refuses():
    model, qp, admm, _ = _port(3)
    with pytest.raises(ValueError, match="method"):
        make_mpc_step(model, qp, admm, method="nope")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_mpc_step(model, qp, admm, repair=(None, "soft"))
    with pytest.raises(ValueError, match="T must"):
        closed_loop(model, make_mpc_step(model, qp, admm), X0, T=0)


def test_n27_loop_follows_reference_where_the_kernels_stream():
    """At N=27 (the shape whose constants the card's kernels stream) the
    first two steps of config 1's B&B loop agree with the reference's:
    the state first moves away from the origin (|x| 2 → 2.016 → 2.19) in
    both, and the objectives agree within the B&B's 1e-3."""
    spec = dict(capacity=256, wave_size=32, max_waves=48, qp_iters=200)
    model, qp, admm, probe = _port(27)
    step = make_mpc_step(model, qp, admm, bnb_spec=BnbSpec(**spec),
                         admm_probe=probe)
    res = closed_loop(model, step, X0, T=2)
    jmodel = jdi.switched_double_integrator()
    jc = JCondensed(jmodel, 27, jdi.default_weights())
    jstep = jmake_step(jmodel, jc.device_qp(), jprep(jc),
                       bnb_spec=JSpec(**spec), admm_probe=jprep(jc, rho=10.0))
    jr = jclosed_loop(jmodel, jstep, jnp.asarray(X0), T=2)
    assert bool(res.found.all()) and bool(np.all(np.asarray(jr.found)))
    np.testing.assert_allclose(res.objs.numpy(), np.asarray(jr.objs),
                               rtol=1e-3)
    np.testing.assert_allclose(res.xs.numpy(), np.asarray(jr.xs), rtol=1e-2,
                               atol=1e-2)
    norms = res.xs.norm(dim=-1)
    assert float(norms[0]) < float(norms[1]) < float(norms[2])
