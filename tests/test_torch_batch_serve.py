"""Batched serving in the port, on the CPU: batched assembly and
rollout-repair seeds against ``jax.vmap`` of the reference's,
``feedback_batch`` against the reference's and against a loop of the
port's ``feedback``, the 2-D request of the serve loop against the
reference's ``_solve_one``, request coalescing and the TCP front (on
localhost), and the rule that entry points run on the card unless asked
for the CPU.

Tolerances: assembly is one fp32 matmul (1e-5); the repair seed runs the
same σ-form ADMM stage solves in both packages (objective rtol=atol=1e-4,
plans 1e-3); B&B results agree on ``found`` and within 1e-3 on the
objective, as in tests/test_torch_slice.py."""

import io
import json
import os
import re
import socket
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyhybridcontrol_tpu.models.double_integrator as jdi
import pyhybridcontrol_tpu.serve as jserve
import pyhybridcontrol_tpu_torch.models.double_integrator as tdi
from pyhybridcontrol_tpu.configs import get_config as j_get_config
from pyhybridcontrol_tpu.control.mpc import MpcController as JController
from pyhybridcontrol_tpu.ops.admm import prepare_admm_mpc
from pyhybridcontrol_tpu.ops.condense import CondensedMpc
from pyhybridcontrol_tpu.solver.bnb import BnbSpec as JSpec
from pyhybridcontrol_tpu.solver.repair import prepare_repair as j_prep_repair
from pyhybridcontrol_tpu.solver.repair import (
    root_repair_incumbent as j_root_repair)
from pyhybridcontrol_tpu_torch import convert, serve
from pyhybridcontrol_tpu_torch.configs import get_config
from pyhybridcontrol_tpu_torch.control.mpc import MpcController
from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca
from pyhybridcontrol_tpu_torch.ops.admm import prepare_admm
from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec
from pyhybridcontrol_tpu_torch.solver.repair import (
    prepare_repair, root_repair_incumbent)

torch.set_num_threads(2)

N, B = 8, 8
# config 4's B&B spec (configs/benchmarks.py scenario_batch), at horizon N
SPEC = dict(capacity=64, wave_size=16, max_waves=24, qp_iters=100)
_repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _states(seed=0, out_of_box=None):
    x = np.random.default_rng(seed).normal(size=(B, 2)).astype(np.float32)
    if out_of_box is not None:
        x[out_of_box] = [12.0, 0.0]          # outside the |x| ≤ 10 box
    return x


@pytest.fixture(scope="module")
def ctrls():
    jc = JController(jdi.switched_double_integrator(), N,
                     jdi.default_weights(), bnb_spec=JSpec(**SPEC),
                     qp_iters=SPEC["qp_iters"])
    tc = MpcController(tdi.switched_double_integrator(), N,
                       tdi.default_weights(), bnb_spec=BnbSpec(**SPEC),
                       qp_iters=SPEC["qp_iters"], device="cpu")
    return jc, tc.build()


def test_batched_assemble_and_full_v_match_vmapped_reference(rng):
    c = CondensedMpc(jdi.switched_double_integrator(), N,
                     jdi.default_weights())
    jq = c.device_qp()
    tq = convert.device_qp(jq, "cpu")
    x0s = _states(1)
    price = rng.normal(size=(N, jq.info.nv)).astype(np.float32)
    up = rng.normal(size=(B, jq.info.nu)).astype(np.float32)
    jf, jh = jax.vmap(lambda x, u: jq.assemble(x, None, u, jnp.asarray(
        price)))(jnp.asarray(x0s), jnp.asarray(up))
    tf, th = tq.assemble(torch.as_tensor(x0s), None, torch.as_tensor(up),
                         torch.as_tensor(price))
    assert tf.shape == (B, tq.n) and th.shape == (B, tq.m)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)
    V = rng.normal(size=(B, tq.n)).astype(np.float32)
    np.testing.assert_allclose(
        tq.full_v(torch.as_tensor(V)).numpy(),
        np.asarray(jax.vmap(jq.full_v)(jnp.asarray(V))), rtol=1e-6,
        atol=1e-6)


def test_batched_root_repair_matches_vmapped_reference():
    """B seeds at once (one (B·C, ·) admm_solve per stage) against
    jax.vmap of the reference's, and against the port's own
    single-instance call."""
    model = jdi.switched_double_integrator()
    c = CondensedMpc(model, N, jdi.default_weights())
    jq, js = c.device_qp(), prepare_admm_mpc(c)
    jr = j_prep_repair(model, jdi.default_weights())
    tq, ts = convert.device_qp(jq, "cpu"), convert.box_qp(js, "cpu")
    tr = prepare_repair(tdi.switched_double_integrator(),
                        tdi.default_weights(), device="cpu")
    x0s = _states(2, out_of_box=5)
    jf, jh = jax.vmap(jq.assemble)(jnp.asarray(x0s))
    j_obj, j_V, j_ok = jax.vmap(
        lambda x, f_, h_: j_root_repair(js, jq, jr, x, f_, h_, qp_iters=100)
    )(jnp.asarray(x0s), jf, jh)
    tx = torch.as_tensor(x0s)
    tf, th = tq.assemble(tx)
    t_obj, t_V, t_ok = root_repair_incumbent(ts, tq, tr, tx, tf, th,
                                             qp_iters=100)
    assert t_V.shape == (B, tq.n) and t_ok.shape == (B,)
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))
    assert not bool(t_ok[5]) and bool(t_ok[0])
    ok = t_ok.numpy()
    np.testing.assert_allclose(t_obj.numpy()[ok], np.asarray(j_obj)[ok],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t_V.numpy()[ok], np.asarray(j_V)[ok],
                               atol=1e-3)
    for i in (0, 5):
        o1, V1, ok1 = root_repair_incumbent(ts, tq, tr, tx[i], tf[i], th[i],
                                            qp_iters=100)
        assert V1.shape == (tq.n,) and bool(ok1) == bool(t_ok[i])
        if ok1:
            np.testing.assert_allclose(float(o1), float(t_obj[i]),
                                       rtol=1e-5, atol=1e-5)


def test_feedback_batch_matches_reference_and_single_feedback(ctrls):
    jc, tc = ctrls
    x0s = _states(0, out_of_box=3)
    jr = jc.feedback_batch(jnp.asarray(x0s))
    tr = tc.feedback_batch(x0s)
    found = tr.found.numpy()
    np.testing.assert_array_equal(found, np.asarray(jr.found))
    assert found.tolist() == [i != 3 for i in range(B)]
    np.testing.assert_allclose(tr.obj.numpy()[found],
                               np.asarray(jr.obj)[found], rtol=1e-3,
                               atol=1e-3)
    info = tc.model.info
    assert tr.u.shape == (B, info.nu) and tr.delta.shape == (B, info.ndelta)
    assert tr.v_seq.shape == (B, N, info.nv) and tr.nodes.shape == (B,)
    np.testing.assert_allclose(tr.u.numpy()[found],
                               np.asarray(jr.u)[found], atol=2e-3)
    assert bool((tr.gap >= 0).all())
    # the batch against a loop of the port's own single-state feedback
    # (every other instance, and the out-of-box one)
    for i in (1, 3, 5, 7):
        one = tc.feedback(x0s[i])
        assert bool(one.found) == bool(found[i])
        if found[i]:
            assert abs(float(one.obj) - float(tr.obj[i])) <= 1e-3 * max(
                1.0, abs(float(one.obj)))
            d = tr.v_seq[i, :, info.delta_slice]
            assert bool(((d - d.round()).abs() < 1e-2).all())


def test_feedback_batch_wave_budget_and_refusals(ctrls, monkeypatch):
    """The wave arithmetic of the reference (wave snapped to a multiple
    of 128, equal per-instance node budget), the "vmap" engine (one
    ``feedback`` per instance) and what still raises."""
    from pyhybridcontrol_tpu_torch.control import mpc

    _, tc = ctrls
    got = {}

    def fake(admm, qp, f, h, spec, pool_slots=0, **kw):
        got.update(spec=spec, P=pool_slots, seeded=kw["init_incumbent"])
        raise RuntimeError("stop here")

    monkeypatch.setattr(mpc, "solve_miqp_bnb_pooled", fake)
    x0s = np.zeros((40, 2), np.float32)
    with pytest.raises(RuntimeError, match="stop here"):
        tc.feedback_batch(x0s, pooled_wave=300)
    assert got["P"] == 32 * 40 and got["spec"].wave_size == 256
    assert got["spec"].max_waves == -(-40 * 24 * 16 // 256)
    assert got["spec"].capacity == 256 and got["seeded"] is not None
    with pytest.raises(RuntimeError, match="stop here"):
        tc.feedback_batch(x0s[:2], pooled_wave=1024)
    assert got["P"] == 64 and got["spec"].wave_size == 64
    calls = []
    monkeypatch.setattr(tc, "feedback", lambda x, W, P, up: calls.append(
        x) or {"obj": x.sum()})
    assert torch.equal(tc.feedback_batch(x0s[:3] + 1.0, engine="vmap").obj,
                       torch.full((3,), 2.0))
    assert len(calls) == 3
    monkeypatch.undo()
    # a batch over ranks (tests/test_torch_sharded_scenarios.py) needs a
    # mesh with a "scen" axis
    no_scen = types.SimpleNamespace(mesh_dim_names=("pool",))
    with pytest.raises(ValueError, match="no axis 'scen'"):
        tc.feedback_batch(x0s, mesh=no_scen)
    with pytest.raises(ValueError, match="engine"):
        tc.feedback_batch(x0s, engine="nope")
    with pytest.raises(ValueError, match="shape"):
        tc.feedback_batch(np.zeros(2, np.float32))
    en = MpcController(tdi.switched_double_integrator(), 4,
                       tdi.default_weights(), solver="enumerate",
                       device="cpu")
    assert en.feedback_batch(x0s[:2]).obj.shape == (2,)   # auto → vmap
    with pytest.raises(ValueError, match="bnb"):
        en.feedback_batch(x0s, engine="pooled")


def test_serve_2d_request_matches_reference_reply(ctrls):
    """A 2-D "x" through the port's stdin loop against the reference's
    ``_solve_one``: same keys, list-valued fields, same values."""
    jc, tc = ctrls
    x0s = _states(4, out_of_box=1)
    req = {"x": x0s.tolist(), "id": "b1"}
    ref = jserve._solve_one(jc, dict(req))
    out = io.StringIO()
    lines = [json.dumps(req), json.dumps({"x": x0s[0].tolist()}),
             json.dumps({"x": [[0.0, 0.0, 0.0]]}), '{"cmd": "quit"}']
    serve.stdin_loop(tc, {"ready": True},
                     inp=io.StringIO("\n".join(lines) + "\n"), out=out)
    ready, rep, one, bad = map(json.loads, out.getvalue().splitlines())
    assert ready == {"ready": True} and rep.pop("id") == "b1"
    assert set(rep) == set(ref) == {"u", "delta", "obj", "found", "batch",
                                    "ms"}
    assert rep["batch"] == ref["batch"] == B and rep["ms"] > 0
    assert rep["found"] == ref["found"] and rep["found"][1] is False
    assert np.shape(rep["u"]) == np.shape(ref["u"])
    assert np.shape(rep["delta"]) == np.shape(ref["delta"])
    f = np.asarray(rep["found"])
    np.testing.assert_allclose(np.asarray(rep["obj"])[f],
                               np.asarray(ref["obj"])[f], rtol=1e-3,
                               atol=1e-3)
    # a 1-D request still gets the scalar reply; a bad shape an error
    assert isinstance(one["obj"], float) and "gap" in one
    assert abs(one["obj"] - rep["obj"][0]) <= 1e-3
    assert "error" in bad


class _FakeCtrl:
    """Records the batch it is given; answers obj[i] = x[i, 0]."""

    def __init__(self):
        self.calls = []

    def feedback_batch(self, x0s, omega_forecasts=None, price_seq=None,
                       u_prevs=None):
        self.calls.append((x0s, omega_forecasts, price_seq, u_prevs))
        Bp = len(x0s)
        x = torch.as_tensor(x0s)
        return dict_like(u=x[:, :1], delta=torch.zeros(Bp, 1), obj=x[:, 0],
                         found=torch.ones(Bp, dtype=torch.bool),
                         gap=torch.zeros(Bp))


def dict_like(**kw):
    from pyhybridcontrol_tpu_torch.utils.structdict import StructDict

    return StructDict(**kw)


@pytest.mark.parametrize("n_req,padded", [(2, 2), (3, 4), (5, 8), (8, 8)])
def test_solve_group_pads_to_a_power_of_two(n_req, padded):
    reqs = [{"x": [float(i), 0.0], "u_prev": [0.5]} for i in range(n_req)]
    fake = _FakeCtrl()
    out = serve._solve_group(fake, reqs)
    x0s, W, Pq, up = fake.calls[0]
    assert x0s.shape == (padded, 2) and up.shape == (padded, 1)
    assert W is None and Pq is None
    # padding repeats the first request
    assert np.all(x0s[n_req:] == x0s[0])
    assert [r["obj"] for r in out] == [float(i) for i in range(n_req)]
    assert all(r["coalesced"] == n_req and r["found"] is True for r in out)
    # the same grouping rule as the reference
    for r in reqs + [{"x": [[0.0, 1.0]]}, {"x": [0.0, 1.0],
                                           "price": [[1.0, 2.0]]}]:
        assert serve._coalesce_key(r) == jserve._coalesce_key(r)
    with pytest.raises(ValueError):
        serve._coalesce_key({"x": [[[0.0]]]})


def test_solve_group_on_the_real_controller(ctrls):
    _, tc = ctrls
    x0s = _states(6)[:3]
    out = serve._solve_group(tc, [{"x": x.tolist()} for x in x0s])
    assert len(out) == 3 and all(r["coalesced"] == 3 for r in out)
    for x, r in zip(x0s, out):
        one = tc.feedback(x)
        assert r["found"] and abs(r["obj"] - float(one.obj)) <= 1e-3


def test_tcp_server_coalesces_concurrent_requests(ctrls):
    """The TCP front on localhost, in process: ping, stats, two clients
    whose requests arrive inside one window and are solved as one batch,
    a deadline that has passed, shutdown."""
    _, tc = ctrls
    srv = serve._TcpServer(tc, {"ready": True}, "127.0.0.1", 0,
                           window_ms=300.0, max_batch=8)
    ready = io.StringIO()
    th = threading.Thread(target=srv.serve_forever, args=(ready,),
                          daemon=True)
    th.start()

    def client():
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=60)
        return s, s.makefile("rw")

    try:
        (s1, f1), (s2, f2) = client(), client()

        def ask(f, obj):
            f.write(json.dumps(obj) + "\n")
            f.flush()

        ask(f1, {"cmd": "ping"})
        assert json.loads(f1.readline()) == {"pong": True}
        ask(f1, {"x": [1.0, -0.5], "id": "a"})
        ask(f2, {"x": [0.2, 0.7], "id": "b"})
        ra, rb = json.loads(f1.readline()), json.loads(f2.readline())
        assert ra["id"] == "a" and rb["id"] == "b"
        assert ra["coalesced"] == rb["coalesced"] == 2
        assert ra["found"] and rb["found"]
        assert abs(ra["obj"] - float(tc.feedback([1.0, -0.5]).obj)) <= 1e-3
        ask(f2, {"x": [0.2, 0.7], "deadline_ms": -1.0, "id": "late"})
        late = json.loads(f2.readline())
        assert late["deadline_exceeded"] and late["id"] == "late"
        ask(f1, {"x": [[1.0, 0.0], [12.0, 0.0]]})      # passes through
        two = json.loads(f1.readline())
        assert two["batch"] == 2 and two["found"] == [True, False]
        ask(f2, {"cmd": "stats"})
        stats = json.loads(f2.readline())
        assert stats["coalesced_batches"] == 1 and stats["requests"] == 3
        assert stats["deadline_shed"] == 1 and stats["connections"] == 2
        ask(f1, {"cmd": "shutdown"})
        assert json.loads(f1.readline()) == {"bye": True}
        th.join(timeout=10.0)
        assert not th.is_alive()
        assert json.loads(ready.getvalue())["tcp_port"] == srv.port
    finally:
        srv.stop.set()
        srv.q.put(None)
        for s in (s1, s2):
            s.close()


def test_scenario_batch_config_matches_reference():
    t, j = get_config("scenario_batch"), j_get_config("scenario_batch")
    assert (t.name, t.N, t.batch) == (j.name, j.N, j.batch) == (
        "scenario_batch", 10, 1024)
    assert convert.bnb_spec(j.bnb) == t.bnb
    assert get_config("double_integrator").batch == 1
    # config 5 runs on one card as one pooled batch (run.py)
    t5, j5 = get_config("sharded_bnb"), j_get_config("sharded_bnb")
    assert (t5.N, t5.T, t5.batch) == (j5.N, j5.T, j5.batch) == (20, 1, 512)
    assert convert.bnb_spec(j5.bnb) == t5.bnb
    with pytest.raises(KeyError, match="definitely_not"):
        get_config("definitely_not")


def _no_card():
    return not torch.cuda.is_available()


@pytest.mark.parametrize("entry", [
    "controller", "prepare_admm", "device_qp", "prepare_repair",
    "convert_box_qp", "convert_device_qp", "build_controller"])
def test_entry_points_default_to_the_card_and_raise_without_one(entry):
    """Every entry point that takes a device defaults to "cuda"; with no
    card it raises instead of carrying on on the CPU."""
    if not _no_card():
        pytest.skip("a CUDA device is present: the defaults would run")
    model, w = tdi.switched_double_integrator(), tdi.default_weights()
    from pyhybridcontrol_tpu_torch.ops.condense import CondensedMpc as TC

    c = TC(model, 3, w)
    jc = CondensedMpc(jdi.switched_double_integrator(), 3,
                      jdi.default_weights())
    calls = {
        "controller": lambda: MpcController(model, 3, w),
        "prepare_admm": lambda: prepare_admm(c.G, c.H),
        "device_qp": lambda: c.device_qp(),
        "prepare_repair": lambda: prepare_repair(model, w),
        "convert_box_qp": lambda: convert.box_qp(prepare_admm_mpc(jc)),
        "convert_device_qp": lambda: convert.device_qp(jc.device_qp()),
        "build_controller": lambda: serve.build_controller(
            "double_integrator"),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


@pytest.mark.cuda
def test_cuda_tensors_always_launch_the_kernels():
    """On a CUDA tensor no path reaches a plain version: every entry
    point counts a launch of its kernel (needs the card and nvcc)."""
    if _no_card():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    model, w = tdi.switched_double_integrator(), tdi.default_weights()
    from pyhybridcontrol_tpu_torch.ops.admm import prepare_admm_mpc as tprep
    from pyhybridcontrol_tpu_torch.ops.condense import CondensedMpc as TC

    c = TC(model, 6, w)
    qp, spec = c.device_qp(), tprep(c)
    x0s = torch.as_tensor(_states(0), device="cuda")
    f, h = qp.assemble(x0s)
    lb, ub = qp.lb.expand(B, -1), qp.ub.expand(B, -1)
    ca.reset_launch_counts()
    ca.admm_solve_auto(spec, f, h, lb, ub, iters=20)
    none = dict.fromkeys(ca.LAUNCHES, 0)
    assert ca.LAUNCHES == {**none, "admm_k1": 1}
    ca.admm_wave_auto(spec, None, qp.binary_idx, f, h, lb, ub, iters=20,
                      probe_iters=20)
    assert ca.LAUNCHES["admm_k2"] == 1
    ca.admm_solve_cuda(ca.kernel_qp_for(spec), f, h, lb.contiguous(),
                       ub.contiguous(), iters=20, low_frac=0.5)
    assert ca.LAUNCHES == {**none, "admm_k1": 2, "admm_k2": 1,
                           "admm_k1_mixed": 1}
    assert ca.LAUNCH_BATCHES["admm_k1_mixed"] == {B: 1}


def test_port_sources_never_import_jax():
    """No module of the port, and not chip_smoke.py, imports jax or the
    JAX package (only tests/test_torch_*.py import both)."""
    pat = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|pyhybridcontrol_tpu)(\s|\.|$)",
        re.M)
    files = [os.path.join(_repo, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(_repo,
                                               "pyhybridcontrol_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    bad = [f for f in files if pat.search(open(f).read())]
    assert not bad, bad
