"""The port's pooled multi-instance B&B (solver/bnb_pooled.py) and the
B&B options it uses, on the CPU, against the reference's pooled engine
and single-instance loop on the shapes of tests/test_bnb_pooled.py
(double integrator, N=8, B=4–8, waves of 16–32). Inputs come from a numpy
seed and go to both packages; the prepared matrices are carried across
(convert.py), so any difference is arithmetic.

The reference runs its XLA wave path here (σ-form ADMM, the sequential
relax → probe composition): its Pallas kernels in interpret mode need
waves that are multiples of 128, too slow for the fast lane. The port
runs the plain versions of K1/K2 (σ=0). The two agree at convergence, so
results are compared on ``found`` (identical), objectives
(rtol=atol=1e-3, the reference's own tolerance between its engines) and
integrality of the binaries (1e-2), never on node counts. One test runs
the reference on its kernel path instead (Pallas in interpret mode, a
wave of 128) and holds waves, nodes and the probe gate's schedule too."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyhybridcontrol_tpu.models.double_integrator as jdi
from pyhybridcontrol_tpu.ops.admm import prepare_admm_mpc
from pyhybridcontrol_tpu.ops.condense import CondensedMpc
from pyhybridcontrol_tpu.solver.bnb import BnbSpec as JSpec
from pyhybridcontrol_tpu.solver.bnb import solve_miqp_bnb as j_bnb
from pyhybridcontrol_tpu.solver.bnb_pooled import (
    solve_miqp_bnb_pooled as j_pooled)
from pyhybridcontrol_tpu_torch import convert
from pyhybridcontrol_tpu_torch.solver import bnb_pooled
from pyhybridcontrol_tpu_torch.solver.bnb import (
    BnbSpec, CondensedBackend, solve_miqp_bnb)
from pyhybridcontrol_tpu_torch.solver.bnb_pooled import (
    KernelCondensedBackend, PooledState, _pooled_loop,
    solve_miqp_bnb_pooled)
from pyhybridcontrol_tpu_torch.utils.select import first_arg, first_k

torch.set_num_threads(2)

TOL = 1e-3          # objectives, rtol = atol
INT_TOL = 1e-2      # binaries of a returned plan


@pytest.fixture(scope="module")
def prob():
    c = CondensedMpc(jdi.switched_double_integrator(), 8,
                     jdi.default_weights())
    jq, js = c.device_qp(), prepare_admm_mpc(c)
    jp = prepare_admm_mpc(c, rho=10.0)
    return dict(jq=jq, js=js, jp=jp, tq=convert.device_qp(jq, "cpu"),
                ts=convert.box_qp(js, "cpu"), tp=convert.box_qp(jp, "cpu"))


def _data(prob, B, seed, scales=None):
    """(f, h) of B seeded states, as jax and as torch arrays."""
    x0s = np.random.default_rng(seed).normal(size=(B, 2)).astype(np.float32)
    f, h = (np.array(a) for a in jax.vmap(prob["jq"].assemble)(
        jnp.asarray(x0s)))
    if scales is not None:
        f = f * np.asarray(scales, np.float32)[:, None]
    return (jnp.asarray(f), jnp.asarray(h)), (torch.as_tensor(f),
                                             torch.as_tensor(h))


def _check(prob, tr, jr):
    t, j = convert.to_numpy(tr), convert.to_numpy(jr)
    np.testing.assert_array_equal(t["found"], j["found"])
    np.testing.assert_allclose(t["obj"], j["obj"], rtol=TOL, atol=TOL)
    xb = t["x"][..., list(prob["tq"].binary_idx)][t["found"]]
    assert np.all(np.abs(xb - np.round(xb)) < INT_TOL)
    assert bool(t["overflow"]) == bool(j["overflow"])
    # best_open_bound is a lower bound on what is left, never above BIG
    assert np.all(t["best_open_bound"] <= 1.0001e30)


BASE = dict(capacity=128, wave_size=32, max_waves=128, qp_iters=200)
SMALL = dict(capacity=64, wave_size=16, max_waves=256, qp_iters=200)
POOLED_CASES = {
    "base": (8, 7, BASE, 1024),
    "rel_gap": (4, 3, dict(SMALL, rel_gap=1e-3), 256),
    "probe_patience": (8, 11, dict(BASE, probe_patience=3), 1024),
    "most_frac": (4, 5, dict(SMALL, branching="most_frac"), 256),
    "no_presolve": (4, 5, dict(SMALL, presolve_fix=False), 256),
    "cold_start": (4, 5, dict(SMALL, warm_start=False), 256),
    "root_iters": (4, 5, dict(SMALL, root_iters=400), 256),
    "overflow": (4, 9, dict(capacity=64, wave_size=8, max_waves=64,
                            qp_iters=200), 12),
}


@pytest.mark.parametrize("case", sorted(POOLED_CASES))
def test_pooled_matches_reference(prob, case):
    B, seed, kw, P = POOLED_CASES[case]
    (jf, jh), (tf, th) = _data(prob, B, seed)
    jspec = JSpec(**kw)
    jr = j_pooled(prob["js"], prob["jq"], jf, jh, jspec, pool_slots=P,
                  admm_probe=prob["jp"])
    tr = solve_miqp_bnb_pooled(prob["ts"], prob["tq"], tf, th,
                               convert.bnb_spec(jspec), pool_slots=P,
                               admm_probe=prob["tp"])
    _check(prob, tr, jr)
    if case == "rel_gap":
        assert tr.waves < kw["max_waves"]      # the gap stop cut the run
        t = convert.to_numpy(tr)
        gap = t["obj"] - t["best_open_bound"]
        assert np.all(gap <= 1e-3 * np.maximum(1.0, np.abs(t["obj"])) + 1e-6)
    if case == "overflow":
        assert bool(tr.overflow)               # 12 slots for 4 instances


def test_pooled_relgap_norm_heterogeneous_scales(prob):
    """pool_norm="relgap": objective scales spanning ~3 orders of
    magnitude; every instance is still served, as in the reference."""
    kw = dict(capacity=128, wave_size=32, max_waves=192, qp_iters=200,
              pool_norm="relgap")
    (jf, jh), (tf, th) = _data(prob, 4, 5, scales=[30.0, 3.0, 1.0, 0.1])
    jr = j_pooled(prob["js"], prob["jq"], jf, jh, JSpec(**kw),
                  pool_slots=1024, admm_probe=prob["jp"])
    tr = solve_miqp_bnb_pooled(prob["ts"], prob["tq"], tf, th, BnbSpec(**kw),
                               pool_slots=1024, admm_probe=prob["tp"])
    assert bool(tr.found.all())
    _check(prob, tr, jr)


def test_pooled_init_node_and_incumbent_seed(prob):
    """init_node: fully-fixed candidates in slots B..2B−1 become
    incumbents through the wave-1 probe (two waves only); init_incumbent:
    a per-instance seed is kept where nothing better is found."""
    kw = dict(capacity=64, wave_size=16, max_waves=2, qp_iters=200)
    B = 4
    (jf, jh), (tf, th) = _data(prob, B, 11)
    nb = len(prob["tq"].binary_idx)
    jr = j_pooled(prob["js"], prob["jq"], jf, jh, JSpec(**kw),
                  pool_slots=256,
                  init_node=(jnp.zeros((B, nb)), jnp.ones((B,), bool), None))
    tr = solve_miqp_bnb_pooled(
        prob["ts"], prob["tq"], tf, th, BnbSpec(**kw), pool_slots=256,
        init_node=(torch.zeros((B, nb)), torch.ones(B, dtype=torch.bool),
                   None))
    assert bool(tr.found.all())
    _check(prob, tr, jr)
    # a seed far below any true optimum survives as the incumbent
    seed_obj = np.full(B, -1e6, np.float32)
    seed_x = np.zeros((B, prob["tq"].n), np.float32)
    ok = np.array([True, False, True, False])
    jr = j_pooled(prob["js"], prob["jq"], jf, jh, JSpec(**kw),
                  pool_slots=256, init_incumbent=tuple(
                      map(jnp.asarray, (seed_obj, seed_x, ok))))
    tr = solve_miqp_bnb_pooled(
        prob["ts"], prob["tq"], tf, th, BnbSpec(**kw), pool_slots=256,
        init_incumbent=tuple(map(torch.as_tensor, (seed_obj, seed_x, ok))))
    _check(prob, tr, jr)
    assert tr.obj[0] == -1e6 and tr.obj[1] > -1e3


@pytest.mark.parametrize("kw", [
    {}, dict(probe_patience=3), dict(rel_gap=1e-3)],
    ids=["base", "probe_patience", "rel_gap"])
def test_pooled_matches_the_ports_single_instance_loop(prob, kw):
    """Pooling changes the schedule, not the search semantics."""
    B = 6
    _, (tf, th) = _data(prob, B, 21)
    res = solve_miqp_bnb_pooled(prob["ts"], prob["tq"], tf, th,
                                BnbSpec(**BASE, **kw), pool_slots=512,
                                admm_probe=prob["tp"])
    spec1 = BnbSpec(capacity=128, wave_size=16, max_waves=48, qp_iters=200,
                    **kw)
    singles = [solve_miqp_bnb(prob["ts"], prob["tq"], tf[i], th[i], spec1,
                              admm_probe=prob["tp"]) for i in range(B)]
    assert res.found.tolist() == [bool(r.found) for r in singles]
    np.testing.assert_allclose(res.obj.numpy(),
                               [float(r.obj) for r in singles],
                               rtol=TOL, atol=TOL)
    assert res.waves < sum(r.waves for r in singles)


SINGLE_CASES = {
    "probe_patience": dict(probe_patience=2),
    "rel_gap": dict(rel_gap=1e-2),
    "root_iters": dict(root_iters=500),
    "most_frac": dict(branching="most_frac"),
    "no_presolve": dict(presolve_fix=False),
    "cold_start": dict(warm_start=False),
}


@pytest.mark.parametrize("case", sorted(SINGLE_CASES))
def test_single_instance_options_match_reference(prob, case):
    """Each newly ported BnbSpec option in the single-instance loop."""
    kw = dict(capacity=128, wave_size=16, max_waves=64, qp_iters=200,
              **SINGLE_CASES[case])
    (jf, jh), (tf, th) = _data(prob, 2, 31)
    for i in range(2):
        jr = j_bnb(prob["js"], prob["jq"], jf[i], jh[i], JSpec(**kw),
                   admm_probe=prob["jp"])
        tr = solve_miqp_bnb(prob["ts"], prob["tq"], tf[i], th[i],
                            BnbSpec(**kw), admm_probe=prob["tp"])
        _check(prob, tr, jr)


@pytest.mark.parametrize("engine", ["pooled", "single"])
def test_probe_gate_closes_with_carried_incumbents(prob, monkeypatch, engine):
    """probe_patience: a search that starts from optimal incumbents (a
    re-solve that carries its plan) finds no better one, so after
    ``probe_patience`` stale waves the probes are gated: those waves run
    the relaxation alone (K1's function, not K2's) and leaf candidates
    wait for the next probing wave. Same answers as the reference, and
    both kinds of wave really ran."""
    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca

    kw = dict(capacity=128, wave_size=4, max_waves=128, qp_iters=200,
              probe_patience=2)
    B = 4 if engine == "pooled" else 1
    (jf, jh), (tf, th) = _data(prob, B, 3)
    calls = {"relax": 0, "wave": 0}
    plain = {"relax": ca.admm_solve_plain, "wave": ca.admm_wave_plain}

    def counted(key):
        def fn(*a, **k):
            calls[key] += 1
            return plain[key](*a, **k)
        return fn

    if engine == "pooled":
        def solve(seed=None):
            return solve_miqp_bnb_pooled(
                prob["ts"], prob["tq"], tf, th, BnbSpec(**kw),
                pool_slots=256, admm_probe=prob["tp"], init_incumbent=seed)

        def j_solve(seed):
            return j_pooled(prob["js"], prob["jq"], jf, jh, JSpec(**kw),
                            pool_slots=256, admm_probe=prob["jp"],
                            init_incumbent=seed)
    else:
        def solve(seed=None):
            return solve_miqp_bnb(prob["ts"], prob["tq"], tf[0], th[0],
                                  BnbSpec(**kw), admm_probe=prob["tp"],
                                  init_incumbent=seed)

        def j_solve(seed):
            return j_bnb(prob["js"], prob["jq"], jf[0], jh[0], JSpec(**kw),
                         admm_probe=prob["jp"], init_incumbent=seed)

    first = solve()
    assert bool(first.found.all())
    seed = (first.obj, first.x, first.found)
    monkeypatch.setattr(ca, "admm_solve_plain", counted("relax"))
    monkeypatch.setattr(ca, "admm_wave_plain", counted("wave"))
    tr = solve(seed)
    assert calls["relax"] > 0 and calls["wave"] > 0
    assert calls["relax"] + calls["wave"] == tr.waves
    jr = j_solve(tuple(jnp.asarray(t.numpy()) for t in seed))
    _check(prob, tr, jr)
    # carrying the incumbents changes no answer
    np.testing.assert_allclose(tr.obj.numpy(), first.obj.numpy(), rtol=TOL,
                               atol=TOL)


def _kernel_prob(N):
    """As ``prob`` at horizon N, with the reference on its kernel path:
    the Pallas kernels in interpret mode (σ=0 iteration, the arithmetic of
    the port's plain K1/K2), which takes waves that are multiples of 128."""
    c = CondensedMpc(jdi.switched_double_integrator(), N,
                     jdi.default_weights())
    jq = c.device_qp()
    js = prepare_admm_mpc(c, pallas_mode="interpret")
    jp = prepare_admm_mpc(c, rho=10.0, pallas_mode="interpret")
    return dict(jq=jq, js=js, jp=jp, tq=convert.device_qp(jq, "cpu"),
                ts=convert.box_qp(js, "cpu"), tp=convert.box_qp(jp, "cpu"))


@pytest.fixture(scope="module")
def prob_kernel():
    return _kernel_prob(8)


def _gate_schedules(prob, monkeypatch, B, seed, wave, pool, carried):
    """Both pooled engines with probe_patience=3 and 100 iterations a node
    on B seeded states (a second solve carrying the first's incumbents
    with ``carried``). Returns (reference result, port result, the waves
    the reference gated, the waves the port gated)."""
    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca

    kw = dict(capacity=wave, wave_size=wave, max_waves=4096, qp_iters=100,
              probe_patience=3)
    (jf, jh), (tf, th) = _data(prob, B, seed)

    # the reference: every evaluation of the gate's lax.cond, in order
    j_probed, cond = [], jax.lax.cond

    def recording_cond(pred, true_fun, false_fun, *operands):
        if getattr(true_fun, "__name__", "") == "wave_probe":
            jax.debug.callback(lambda p: j_probed.append(bool(p)), pred,
                               ordered=True)
        return cond(pred, true_fun, false_fun, *operands)

    monkeypatch.setattr(jax.lax, "cond", recording_cond)

    def j_solve(inc=None):
        res = j_pooled(prob["js"], prob["jq"], jf, jh, JSpec(**kw),
                       pool_slots=pool, admm_probe=prob["jp"],
                       init_incumbent=inc)
        jax.block_until_ready(res.obj)
        jax.effects_barrier()
        return res

    # the port: which plain version each wave called
    t_probed = []
    plain = {True: ca.admm_wave_plain, False: ca.admm_solve_plain}

    def recording(probed):
        def fn(*a, **k):
            t_probed.append(probed)
            return plain[probed](*a, **k)
        return fn

    monkeypatch.setattr(ca, "admm_wave_plain", recording(True))
    monkeypatch.setattr(ca, "admm_solve_plain", recording(False))

    def t_solve(inc=None):
        return solve_miqp_bnb_pooled(prob["ts"], prob["tq"], tf, th,
                                     BnbSpec(**kw), pool_slots=pool,
                                     admm_probe=prob["tp"],
                                     init_incumbent=inc)

    jr, tr = j_solve(), t_solve()
    if carried:
        j_probed.clear()
        t_probed.clear()
        jr = j_solve((jr.obj, jr.x, jr.found))
        tr = t_solve((tr.obj, tr.x, tr.found))
    _check(prob, tr, jr)
    assert len(j_probed) == int(jr.waves) and len(t_probed) == tr.waves
    assert abs(tr.waves - int(jr.waves)) <= 2
    assert abs(int(tr.nodes_solved) - int(jr.nodes_solved)) \
        <= 0.02 * int(jr.nodes_solved)
    return (jr, tr, [w for w, ran in enumerate(j_probed) if not ran],
            [w for w, ran in enumerate(t_probed) if not ran])


# (instances, seed of the states, second solve carrying the first's
# incumbents)
GATE_CASES = {"from_nothing": (128, 0, False),
              "carried_incumbents": (32, 0, True)}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_probe_gate_schedule_matches_reference_kernel_path(
        prob_kernel, monkeypatch, case):
    """probe_patience=3 at a global wave of 128 and 100 iterations a node
    (the reference bench's config-4 call, scaled down): which waves the
    gate closes on, the wave count and the node count, against the
    reference's pooled engine on its kernel path. Both iterate σ=0 in
    fp32 with sums in another order, so a probe that improves an
    incumbent by rounding noise on one side may not on the other: the
    waves agree to 2, the nodes to 2%, and the gated waves exactly up to
    the first retry wave that finds an improvement.

    From nothing, with 128 instances, some probe improves an incumbent in
    nearly every wave: the gate closes on NO wave, in the reference as in
    the port. Carrying its own incumbents, each side gates waves 3, 5, 6
    and 7 (stale after waves 0-2; wave 4 is a retry wave)."""
    B, seed, carried = GATE_CASES[case]
    _, _, j_gated, t_gated = _gate_schedules(prob_kernel, monkeypatch, B,
                                             seed, 128, 1024, carried)
    if carried:
        assert j_gated[:4] == t_gated[:4] == [3, 5, 6, 7]
        assert abs(len(j_gated) - len(t_gated)) <= 2
    else:
        assert j_gated == t_gated == []


@pytest.mark.slow
def test_probe_gate_never_closes_on_the_config4_call(monkeypatch, capsys):
    """The reference bench's config-4 call at full size on the CPU (N=10,
    1024 states drawn as the bench draws them, wave 1024, pool 8·B,
    probe_patience=3, 100 iterations a node; slow lane): from nothing,
    neither the reference on its kernel path nor the port gates a single
    wave, so neither reaches K1 there. Prints both schedules (-s)."""
    jr, tr, j_gated, t_gated = _gate_schedules(
        _kernel_prob(10), monkeypatch, 1024, 0, 1024, 8 * 1024, False)
    with capsys.disabled():
        print(f"\nreference: {int(jr.waves)} waves, "
              f"{int(jr.nodes_solved)} nodes, gated {j_gated}; port: "
              f"{tr.waves} waves, {int(tr.nodes_solved)} nodes, gated "
              f"{t_gated}")
    assert bool(tr.found.all())
    assert j_gated == t_gated == []


def test_single_instance_init_node(prob):
    kw = dict(capacity=64, wave_size=16, max_waves=1, qp_iters=200)
    (jf, jh), (tf, th) = _data(prob, 1, 41)
    nb = len(prob["tq"].binary_idx)
    jr = j_bnb(prob["js"], prob["jq"], jf[0], jh[0], JSpec(**kw),
               init_node=(jnp.ones(nb), jnp.asarray(True), None))
    tr = solve_miqp_bnb(prob["ts"], prob["tq"], tf[0], th[0], BnbSpec(**kw),
                        init_node=(torch.ones(nb), torch.tensor(True), None))
    _check(prob, tr, jr)
    assert bool(tr.found) and tr.waves == 1


def test_non_accumulating_scatters_hit_only_the_dump_row_twice(
        prob, monkeypatch):
    """A non-accumulating index_put_ with duplicate indices is
    nondeterministic on CUDA: in every wave, duplicates of such a scatter
    may only be the dump row (winners are unique per instance, selected
    and free slots are distinct). The hook also sees the pseudo-cost
    scatter-add ("pc"), which accumulates: its misses go to the dump row."""
    seen = {}

    def hook(name, idx, dump):
        assert int(idx.min()) >= 0 and int(idx.max()) <= dump, name
        if name == "pc":
            seen[name] = seen.get(name, 0) + int((idx == dump).sum())
            return
        vals, counts = torch.unique(idx, return_counts=True)
        dup = vals[counts > 1]
        assert dup.numel() == 0 or dup.tolist() == [dump], (name, dup)
        seen[name] = seen.get(name, 0) + int((idx == dump).sum())

    monkeypatch.setattr(bnb_pooled, "SCATTER_HOOK", hook)
    _, (tf, th) = _data(prob, 8, 7)
    res = solve_miqp_bnb_pooled(
        prob["ts"], prob["tq"], tf, th,
        BnbSpec(**dict(BASE, probe_patience=2)), pool_slots=1024,
        admm_probe=prob["tp"])
    assert bool(res.found.all())
    assert set(seen) == {"inc_xf", "meta_parent", "node_parent",
                         "meta_child1", "node_child1", "pc"}
    assert seen["pc"] > 0                    # unobserved rows are dumped
    assert seen["meta_parent"] == 0          # selected slots are real slots
    assert seen["inc_xf"] > 0 and seen["meta_child1"] > 0   # drops happen


def test_unfused_composition_matches_the_fused_wave(prob):
    """A backend without ``solve_wave`` runs relax → probe as two solves,
    as the reference does; same incumbents as the fused wave."""

    class Unfused:
        def __init__(self, inner):
            self._inner = inner

        def __getattr__(self, name):
            if name == "solve_wave":
                raise AttributeError(name)
            return getattr(self._inner, name)

    _, (tf, th) = _data(prob, 4, 3)
    fused = KernelCondensedBackend(prob["ts"], prob["tq"], prob["tp"])
    assert KernelCondensedBackend is CondensedBackend
    spec = BnbSpec(**SMALL)
    a = _pooled_loop(fused, tf, th, spec, 256)
    b = _pooled_loop(Unfused(fused), tf, th, spec, 256)
    assert a.found.tolist() == b.found.tolist() == [True] * 4
    np.testing.assert_allclose(a.obj.numpy(), b.obj.numpy(), rtol=TOL,
                               atol=TOL)


def test_pooled_state_layout_and_result_fields(prob):
    """The packed layout of the reference: meta (P+1, 8), node
    (P+1, nb+n+2mt), pc (nb+1, 2, 2), inc_xf (B+1, n+1) — each with its
    dump row — and ids stored as exact floats."""
    B, P = 4, 64
    _, (tf, th) = _data(prob, B, 3)
    res, st = solve_miqp_bnb_pooled(prob["ts"], prob["tq"], tf, th,
                                    BnbSpec(**SMALL), pool_slots=P,
                                    return_state=True)
    assert isinstance(st, PooledState)
    n, nb, mt = prob["tq"].n, len(prob["tq"].binary_idx), prob["ts"].m_total
    assert st.meta.shape == (P + 1, 8)
    assert st.node.shape == (P + 1, nb + n + 2 * mt)
    assert st.pc.shape == (nb + 1, 2, 2)
    assert st.inc_xf.shape == (B + 1, n + 1)
    s = convert.to_numpy(st)
    inst = s["meta"][:P, 5]
    assert np.all(inst == np.round(inst)) and inst.min() >= 0 and \
        inst.max() < B
    assert np.all(np.isin(s["node"][:P, :nb], (-1.0, 0.0, 1.0)))
    assert s["meta"][P, 6] == 0.0            # the dump row is never active
    r = convert.to_numpy(res)
    assert set(r) == {f.name for f in dataclasses.fields(type(res))}
    assert r["x"].shape == (B, n) and r["obj"].shape == (B,)
    np.testing.assert_array_equal(r["x"], s["inc_xf"][:B, :-1])


def test_pooled_refusals(prob):
    _, (tf, th) = _data(prob, 4, 3)
    args = (prob["ts"], prob["tq"], tf, th)
    # branch_map is ported (tests/test_torch_scenario_tree.py): one group
    # id per binary, else it refuses
    with pytest.raises(ValueError, match="branch_map"):
        solve_miqp_bnb_pooled(*args, BnbSpec(**SMALL),
                              branch_map=np.arange(7))
    # the single-instance search options: the reference's pooled engine
    # ignores them (flip-delta runs as most-fractional); the port's refuses
    for kw in (dict(dive_slots=2), dict(sb_iters=50), dict(sb_fix=True),
               dict(depth_tiebreak=1e-2), dict(branching="flipdelta")):
        with pytest.raises(NotImplementedError, match="pooled.*ROADMAP"):
            solve_miqp_bnb_pooled(*args, BnbSpec(**dict(SMALL, **kw)))
    with pytest.raises(ValueError, match="2\\*B"):
        solve_miqp_bnb_pooled(*args, BnbSpec(**SMALL), pool_slots=7)
    with pytest.raises(ValueError, match="pool_slots"):
        solve_miqp_bnb_pooled(*args, BnbSpec(**SMALL), pool_slots=8)


def test_selection_helpers_follow_jax_tie_rules(rng):
    """first_k = lax.top_k / stable argsort, first_arg = jnp.argmax /
    argmin, on data that is mostly ties (as a pool is)."""
    v = rng.integers(0, 3, size=200).astype(np.float32)
    v[rng.uniform(size=200) < 0.5] = 1e30
    t = torch.as_tensor(v)
    _, j_idx = jax.lax.top_k(-jnp.asarray(v), 32)
    assert first_k(t, 32).tolist() == np.asarray(j_idx).tolist()
    _, j_idx = jax.lax.top_k(jnp.asarray(v), 32)
    assert first_k(t, 32, descending=True).tolist() == \
        np.asarray(j_idx).tolist()
    assert first_k(t, 200).tolist() == \
        np.asarray(jnp.argsort(jnp.asarray(v))).tolist()
    m = rng.integers(0, 2, size=(16, 10)).astype(np.float32)
    assert first_arg(torch.as_tensor(m), dim=1).tolist() == \
        np.asarray(jnp.argmax(jnp.asarray(m), axis=1)).tolist()
    assert int(first_arg(t, largest=False)) == int(jnp.argmin(jnp.asarray(v)))
    assert int(first_arg(torch.zeros(5))) == 0


def test_bnb_spec_is_carried_across_field_by_field():
    j = JSpec(capacity=256, wave_size=128, max_waves=7, qp_iters=50,
              feas_tol=2e-3, infeas_tol=0.4, int_tol=2e-3, gap=1e-3,
              inc_tol=1e-4, warm_start=False, probe_iters=30, rel_gap=1e-2,
              probe_patience=3, branching="most_frac", presolve_fix=False,
              pool_norm="relgap", root_iters=90)
    t = convert.bnb_spec(j)
    names = {f.name for f in dataclasses.fields(JSpec)}
    assert names == {f.name for f in dataclasses.fields(BnbSpec)}
    assert all(getattr(t, k) == getattr(j, k) for k in names)
    j = JSpec(sb_iters=5, sb_fix=True, dive_slots=4, depth_tiebreak=1e-3,
              branching="flipdelta")
    t = convert.bnb_spec(j)
    assert all(getattr(t, k) == getattr(j, k) for k in names)
