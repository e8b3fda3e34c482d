"""The B&B search options of the port (solver/bnb.py): the depth
tie-break, flip-delta branching, root strong branching (``sb_iters``,
``sb_fix``) and the diving lane (``dive_slots``), against the reference's
tests/test_bnb_search.py option tests and the exact fp64 enumeration
oracle, on the CPU.

The instance is the reference's (double integrator, N=6, x0=[2, 0],
capacity 128, wave 8, 400 iterations); its prepared matrices are carried
across (convert.py), so any difference is arithmetic: the reference runs
its XLA path (σ-form ADMM), the port the plain K1/K2 (σ=0). Tolerances:
``found`` equal; objectives within 1e-3 (relative, floor 1) of the
reference's and of the oracle's; certified bounds at or below the oracle
+ 1e-4. Node counts are not compared (search order may differ)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyhybridcontrol_tpu.models.double_integrator as jdi
from pyhybridcontrol_tpu.ops import stagewise as jsw
from pyhybridcontrol_tpu.ops.admm import prepare_admm_mpc
from pyhybridcontrol_tpu.ops.condense import CondensedMpc
from pyhybridcontrol_tpu.solver import bnb_stagewise as jbs
from pyhybridcontrol_tpu.solver.bnb import BnbSpec as JSpec
from pyhybridcontrol_tpu.solver.bnb import solve_miqp_bnb as j_bnb
from pyhybridcontrol_tpu_torch import convert
from pyhybridcontrol_tpu_torch.ops import stagewise as tsw
from pyhybridcontrol_tpu_torch.solver import bnb_pooled
from pyhybridcontrol_tpu_torch.solver import bnb_stagewise as tbs
from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec, solve_miqp_bnb
from pyhybridcontrol_tpu_torch.solver.oracle import (
    solve_miqp_enumeration_oracle,
)

torch.set_num_threads(2)

BIG = 1e30
TOL = 1e-3


@pytest.fixture(scope="module")
def prob():
    c = CondensedMpc(jdi.switched_double_integrator(), 6,
                     jdi.default_weights())
    jq, js = c.device_qp(), prepare_admm_mpc(c)
    x0 = np.array([2.0, 0.0], np.float32)
    jf, jh = jq.assemble(jnp.asarray(x0))
    tq, ts = convert.device_qp(jq, "cpu"), convert.box_qp(js, "cpu")
    tf, th = tq.assemble(torch.as_tensor(x0))
    fo, ho = c.assemble_np(x0)
    oracle = solve_miqp_enumeration_oracle(
        np.asarray(c.H), fo, np.asarray(c.G), ho, c.lb, c.ub, c.binary_idx)
    assert oracle.status == "optimal"
    return dict(j=(js, jq, jf, jh), t=(ts, tq, tf, th), oracle=oracle.obj)


def _base(**kw):
    return dict(dict(capacity=128, wave_size=8, max_waves=64, qp_iters=400),
                **kw)


def _both(prob, j_init=None, t_init=None, **kw):
    jr = j_bnb(*prob["j"], JSpec(**_base(**kw)), init_incumbent=j_init)
    tr = solve_miqp_bnb(*prob["t"], BnbSpec(**_base(**kw)),
                        init_incumbent=t_init)
    return jr, tr


def _rel(a, b):
    return abs(float(a) - float(b)) / max(1.0, abs(float(b)))


def _held(prob, jr, tr):
    """Same ``found``; the port's objective within TOL of the reference's
    and of the oracle's; the exit certificate at or below the optimum."""
    assert bool(tr.found) and bool(jr.found)
    assert _rel(tr.obj, jr.obj) <= TOL
    assert _rel(tr.obj, prob["oracle"]) <= TOL
    bo = float(tr.best_open_bound)
    if bo < BIG * 0.99:
        assert bo <= prob["oracle"] + 1e-4


@pytest.mark.parametrize("dt", [1e-3, 1e-2])
def test_depth_tiebreak_matches_reference(prob, dt):
    """Search order only: the optimum of the dt=0 run, the reference's."""
    jr, tr = _both(prob, depth_tiebreak=dt)
    _held(prob, jr, tr)
    plain = solve_miqp_bnb(*prob["t"], BnbSpec(**_base()))
    assert _rel(tr.obj, plain.obj) <= 1e-4


@pytest.mark.parametrize("presolve_fix", [True, False])
def test_flipdelta_branching_matches_reference(prob, presolve_fix):
    """Flip-delta scores with the node presolve's data; without it the
    rule falls back to most-fractional, as the reference's does."""
    jr, tr = _both(prob, branching="flipdelta", presolve_fix=presolve_fix)
    _held(prob, jr, tr)
    if not presolve_fix:
        mf = solve_miqp_bnb(*prob["t"], BnbSpec(**_base(
            branching="most_frac", presolve_fix=False)))
        assert float(mf.obj) == float(tr.obj)
        assert int(mf.nodes_solved) == int(tr.nodes_solved)


def test_strong_branching_preserves_optimum(prob):
    """One batch of all 2·nb candidate children seeds the pseudo-costs,
    fixes certificate-losing binaries and lifts the root bound; none of it
    may change the optimum."""
    jr, tr = _both(prob, sb_iters=200, sb_fix=True)
    _held(prob, jr, tr)


def test_strong_branching_root_lift_is_valid(prob):
    """With no wave the exit bound is the lifted root bound itself:
    max_j min(cert_j0, cert_j1) — at or below the optimum and the
    reference's lift (the same certificates, K1's plain version against
    the σ-form path); after one wave still at or below the optimum."""
    jr, tr = _both(prob, max_waves=0, sb_iters=400, sb_fix=True)
    lift = float(tr.best_open_bound)
    assert lift <= prob["oracle"] + 1e-4
    assert _rel(lift, jr.best_open_bound) <= TOL
    none = solve_miqp_bnb(*prob["t"], BnbSpec(**_base(max_waves=0)))
    assert lift > float(none.best_open_bound)       # it did lift (−BIG)
    jr, tr = _both(prob, max_waves=1, sb_iters=400, sb_fix=True)
    assert float(tr.best_open_bound) <= prob["oracle"] + 1e-4


def test_strong_branching_with_incumbent_seed(prob):
    """With an incumbent the reduced-cost arm of the root fixing engages;
    the seed is the optimum, so the optimum must survive."""
    exact = solve_miqp_bnb(*prob["t"], BnbSpec(**_base()))
    jexact = j_bnb(*prob["j"], JSpec(**_base()))
    jr, tr = _both(prob, j_init=(jexact.obj, jexact.x, jexact.found),
                   t_init=(exact.obj, exact.x, exact.found),
                   sb_iters=300, sb_fix=True)
    _held(prob, jr, tr)
    assert _rel(tr.obj, exact.obj) <= 1e-5


@pytest.mark.parametrize("k", [1, 6])
def test_dive_slots_matches_enumeration(prob, k):
    """The diving lane is search order only: the enumeration optimum, the
    reference's objective, and no subtree dropped."""
    jr, tr = _both(prob, dive_slots=k)
    _held(prob, jr, tr)
    assert not bool(tr.overflow)


def test_dive_lane_short_frontier_writes_only_the_dump_row(prob,
                                                            monkeypatch):
    """Wave 1 has one active node and 6 dive slots: the reference points
    the surplus picks at its out-of-bounds sentinel (the scatters drop);
    the port's select the dump row C, invalid. Every pool scatter may
    repeat only the dump row, and the first wave's parent scatter hits it
    once per surplus pick."""
    C = 128
    seen = []

    def hook(name, idx, dump):
        assert dump == C, name
        assert int(idx.min()) >= 0 and int(idx.max()) <= dump, name
        vals, counts = torch.unique(idx, return_counts=True)
        assert vals[counts > 1].tolist() in ([], [dump]), name
        seen.append((name, int((idx == dump).sum())))

    monkeypatch.setattr(bnb_pooled, "SCATTER_HOOK", hook)
    tr = solve_miqp_bnb(*prob["t"], BnbSpec(**_base(dive_slots=6)))
    assert bool(tr.found) and _rel(tr.obj, prob["oracle"]) <= TOL
    assert seen[0] == ("bnb_parent", 6)
    assert {n for n, _ in seen} == {"bnb_parent", "bnb_child1"}
    assert len(seen) == 2 * tr.waves


def test_strong_branching_on_the_stagewise_backend():
    """sb_iters through the shared loop on the stagewise frame (N=4): the
    candidate batch is the stagewise relaxation's (the plain loop here),
    the objective the reference's stagewise B&B's with the same option."""
    N, x0 = 4, np.array([2.0, 0.0], np.float32)
    js = jsw.prepare_stagewise(jdi.switched_double_integrator(), N,
                               jdi.default_weights())
    ts = convert.stagewise_qp(js, "cpu")
    spec = dict(capacity=64, wave_size=8, qp_iters=300, max_waves=24,
                sb_iters=200, sb_fix=True)
    jr = jbs.solve_miqp_bnb_stagewise(
        js, *jsw.assemble_stagewise(js, jnp.asarray(x0)), JSpec(**spec))
    tr = tbs.solve_miqp_bnb_stagewise(
        ts, *tsw.assemble_stagewise(ts, torch.as_tensor(x0)),
        BnbSpec(**spec))
    assert bool(tr.found) and bool(jr.found)
    assert _rel(tr.obj, jr.obj) <= TOL
    plain = tbs.solve_miqp_bnb_stagewise(
        ts, *tsw.assemble_stagewise(ts, torch.as_tensor(x0)),
        BnbSpec(**dict(spec, sb_iters=0, sb_fix=False)))
    assert _rel(tr.obj, plain.obj) <= TOL


def test_bnb_spec_carries_every_search_option():
    """convert.bnb_spec carries the search options field by field."""
    j = JSpec(capacity=256, wave_size=32, sb_iters=400, sb_fix=True,
              dive_slots=16, depth_tiebreak=1e-2, branching="flipdelta",
              root_iters=3200)
    t = convert.bnb_spec(j)
    assert dataclasses.asdict(t) == {
        f.name: getattr(j, f.name) for f in dataclasses.fields(JSpec)}


def test_chip_smoke_strong_branching_batch_on_the_cpu():
    """The batch chip_smoke.py holds K1 to at root strong branching
    (config 2 from [1.5, 0]): 2·nb = 120 rows, row j fixing binary j to 0
    and row nb + j to 1 and nothing else, all warm from the one root
    iterate; the same rows as the reference builds (rows [0, nb) fix 0)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    st = cs.cfg2_setup("cpu")
    q, h, lb, ub, warm = cs.sb_batch(st, torch.tensor(cs.CFG2_X0))
    bidx = torch.as_tensor(st.qp.binary_idx)
    nb = len(bidx)
    assert q.shape == (2 * nb, st.qp.n) and nb == 60
    fixed = lb[:, bidx] == ub[:, bidx]
    assert torch.equal(fixed, torch.eye(nb, dtype=torch.bool).repeat(2, 1))
    vals = lb[:, bidx][fixed]
    assert torch.equal(vals, torch.cat([torch.zeros(nb), torch.ones(nb)]))
    assert all(torch.equal(w, w[:1].expand_as(w)) for w in warm)
