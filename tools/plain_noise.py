"""The plain version's own fp32 noise on config 4c's pooled wave, on
config 6's stagewise wave, on the served config-2 request's wave, on the
decentralized micro-grid agents' wave, on config 4b's pooled wave, or of
the one-pass split phase (a development tool, not part of the package;
runs on the CPU):

    python tools/plain_noise.py [--batch B] [--seed S]
    python tools/plain_noise.py --stagewise [--seed S]
    python tools/plain_noise.py --served [--seed S]
    python tools/plain_noise.py --decentralized [--seed S]
    python tools/plain_noise.py --strong-branching [--seed S]
    python tools/plain_noise.py --config4b [--seed S]
    python tools/plain_noise.py --paths [--seed S]
    python tools/plain_noise.py --big-shapes [--seed S]
    python tools/plain_noise.py --one-pass [--seed S]
    python tools/plain_noise.py --flex [--seed S]
    python tools/plain_noise.py --any [--seed S]

Builds config 4c's dense joint frame (the reference bench's tree: S=4,
N=10, branching at steps 1 and 5), draws B seeded states and B&B-node
boxes that fix 30% of the information-set groups, and runs the plain
version of K1 (``ops/cuda_admm.admm_solve_plain``) in float32 and the same
iteration in float64 on the wave the pooled engine runs under rep-map
branching: the relaxation (100 iterations, warm from 100 cold), the probe
on the boxes that fix every group to its rounded mean (200 iterations at
ρ·10, then 200 at ρ, warm from the relaxation), and that probe again
after a one-ulp change of q. Prints, per field, the error
``chip_smoke.py`` holds a kernel to — max |Δ| / max(|ref|, floor), floor
1 for obj/x/z/y and 1e-3 for the residuals — of float32 against float64.
Where these readings are well under the "main" limits, the kernels are
held to "main" there.

``--stagewise``: config 6's long-arm frame (S=8, N=120, Σu ≤ 60;
``chip_smoke.config6_trees``) and a wave of 8 nodes with 30% of the
information-set representatives fixed at random (``chip_smoke.node_wave``,
seeded by S): the stagewise tree relaxation (150 iterations) and the probe
(every representative fixed to its rounded value, 1000 iterations at ρ·10,
warm from the relaxation) through the plain sweeps, in float32 against
float64, and the probe again after a one-ulp change of q — what phase 20
of ``chip_smoke.py`` holds K4's whole solve to.

``--flex``: the waves ``chip_smoke.flex_waves`` draws at ``--seed``
(the long_horizon controllers' frames, the double integrator at N=1000
and the PWA hull model at N=300, and config 6's tree at S = 16, 27 and
64): the plain loop's relaxation (``chip_smoke.K5_RELAX`` iterations,
cold, float32), then ``chip_smoke.FLEX_HOLD_ITERS`` iterations from it in
float32 against float64, and again after a one-ulp change of q (float32
both), on x, z, y, dy and the extra rows' carries — what phase 35 holds
K5's grouped, global-state and horizon variants to ("k5_flex"); at the
long_horizon frames also the same with the windowed sweep
(``_solve_K_windowed`` on the horizon plan's windows), what it holds the
horizon variant's parallel sweep to ("k5_horizon_par").

``--any``: the same at the waves ``chip_smoke.any_waves`` draws at
``--seed`` (the battery fleets at b = 20, 32, 64 and 128, four ω double
integrators in a tree of S = 16, config 6's long arm with 5, 20 and 300
extra rows): what phase 37 holds K5 past its register path to ("k5_any",
"k5_rt").

``--served``: config 2's real frame (``chip_smoke.real_problem``, 64
seeded states and node boxes, seeded by S) and the wave a served request
runs: the relaxation of 400 iterations, warm from 400 cold, in float32
against float64, and again after a one-ulp change of q, with the share of
instances that round a relaxed binary otherwise — what phase 9 of
``chip_smoke.py`` holds resident K2 at that shape to.

``--decentralized``: the decentralized agents' wave as phase 23 of
``chip_smoke.py`` draws it at ``--seed`` (``chip_smoke.surface_problem``:
128 nodes of the DEWH frame at N=8, 200 + 200 iterations at ρ, warm from a
cold wave), K2's plain version in float32 against float64: the field
errors, the instances that round a relaxed binary otherwise, and the
certificate bits that differ, with how many of those lie outside
``chip_smoke.CERT_BAND`` of their threshold — what FLIP_SHARE_DEC and
CERT_BAND_DEC are read against.

``--strong-branching``: root strong branching's candidate batch on config
2 as ``chip_smoke.phase_sb_batch`` draws it at ``--seed`` (the 120
children of the root, each one binary fixed, 400 iterations warm from the
root relaxation), K1's plain version in float32 against float64: the
field errors and the certificate bits that differ (``sb_fix`` fixes
binaries from them) — what the "strong_branching" limits are read
against.

``--config4b``: config 4b's pooled wave as phase 9 of ``chip_smoke.py``
draws it at ``--seed`` (``chip_smoke.real_problem`` after the config-2 and
config-3 draws before it: 1024 nodes of the DEWH frame at N=24, 150 + 150
iterations, the stiff probe prep, warm from a cold wave), K2's plain
version in float32 against float64: the field errors of the relaxation and
of the probe (on the instances that round alike), the instances that
round a relaxed binary otherwise (with the farthest such binary from
0.5), and the certificate bits that differ with the factor within which
the farthest of them lies of its threshold (``chip_smoke.cert_factor``) —
what FLIP_SHARE at B=1024 is read against. ``--paths``: the same at every
path shape of phase 9 (``chip_smoke.PATH_SHAPES``: the config-2 call's
wave, config 3's loop wave, config 4b's wave, the served config-2 wave),
what their probes' limits and config 3's certificate band are read
against. ``--big-shapes``: the same at phase 9's B=300
shapes of the real frames (configs 3, 4b and 2; 100 + 100 iterations,
cold), what the "real_probe" limits are read against.

``--one-pass``: the problems of phase 34 of ``chip_smoke.py`` at
``--seed`` (the double integrator at N=20 and N=27, B=4096, every one of
100 iterations in the split phase): K1's plain version with one bf16 pass
a product and with three, each against itself after a one-ulp change of q
— the spread of the iterates the split phase's own rounding gives, what
the "mixed_1pass" limits are read against (float64 has no bf16 passes to
compare with).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

FLOOR = dict(obj=1.0, x=1.0, z=1.0, y=1.0, r_prim=1e-3, r_prim_rel=1e-3,
             r_dual=1e-3)


def _double(kq):
    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca

    return ca.KernelQP(**{
        f.name: (getattr(kq, f.name).double()
                 if isinstance(getattr(kq, f.name), torch.Tensor)
                 else getattr(kq, f.name))
        for f in dataclasses.fields(kq)})


def _errors(got, ref):
    return {k: float(((getattr(got, k).double() - getattr(ref, k)).abs()
                      / getattr(ref, k).abs().clamp_min(v)).max())
            for k, v in FLOOR.items()}


def readings(B=300, seed=5):
    """{stage: {field: error}} of float32 against float64 (see the module
    docstring)."""
    from pyhybridcontrol_tpu_torch.mld.info import MldInfo
    from pyhybridcontrol_tpu_torch.mld.model import MldModel
    from pyhybridcontrol_tpu_torch.models import (
        di_default_weights, switched_double_integrator)
    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca
    from pyhybridcontrol_tpu_torch.ops import scenario_tree as st
    from pyhybridcontrol_tpu_torch.ops.admm import prepare_admm_mpc
    from pyhybridcontrol_tpu_torch.ops.condense import CondensedMpc

    base = switched_double_integrator()
    m = base.numpy_mats()
    model = MldModel.from_matrices(
        MldInfo(nx=2, nu=1, ndelta=1, nz=1, nomega=1, ny=2,
                ncons=base.info.ncons),
        A=m.A, B1=m.B1, B3=m.B3, B4=np.array([[0.0], [1.0]]), C=m.C,
        E=m.E, F1=m.F1, F2=m.F2, F3=m.F3, f5=m.f5)
    tree = st.ScenarioTree.from_branching(
        st.tree_consistent_paths(np.random.default_rng(13), 4, 10, (1, 5),
                                 sd=0.2), branch_steps=(1, 5))
    c = st.build_scenario_tree_qp(
        CondensedMpc(model, 10, di_default_weights()), tree)
    groups = st.tree_branch_map(c, tree)
    ng = int(groups.max()) + 1
    qp = c.device_qp("cpu")
    kq = ca.kernel_qp_for(prepare_admm_mpc(c, device="cpu"))
    kq2 = ca.kernel_qp_for(prepare_admm_mpc(c, rho=10.0, device="cpu"))
    kd, kd2 = _double(kq), _double(kq2)

    rng = np.random.default_rng(seed)
    x0s = torch.as_tensor(rng.normal(size=(B, 2)).astype(np.float32))
    W = torch.as_tensor(tree.omega_paths.reshape(1, -1, 1),
                        dtype=torch.float32).expand(B, -1, -1)
    f, h = qp.assemble(x0s, W)
    bidx = torch.as_tensor(qp.binary_idx)
    g = torch.as_tensor(groups)
    fm = torch.as_tensor(rng.uniform(size=(B, ng)) < 0.3)[:, g]
    fv = torch.as_tensor((rng.uniform(size=(B, ng)) < 0.5)
                         .astype(np.float32))[:, g]
    lb, ub = qp.lb.expand(B, -1).clone(), qp.ub.expand(B, -1).clone()
    lb[:, bidx] = torch.where(fm, fv, 0.0)
    ub[:, bidx] = torch.where(fm, fv, 1.0)

    def solve(k, a, b, lo, hi, iters, warm):
        if k.AGT.dtype == torch.float64:
            return ca._solve_plain(k, a.double(), b.double(), lo.double(),
                                   hi.double(), iters, 0,
                                   tuple(w.double() for w in warm))
        return ca.admm_solve_plain(k, a, b, lo, hi, iters=iters, warm=warm)

    out = {}
    cold = ca.admm_solve_plain(kq, f, h, lb, ub, iters=100)
    warm = (cold.x, cold.z, cold.y)
    r32 = solve(kq, f, h, lb, ub, 100, warm)
    out["relaxation, 100 it warm"] = _errors(r32, solve(kd, f, h, lb, ub,
                                                        100, warm))
    Mavg = torch.zeros((len(groups), ng))
    Mavg[torch.arange(len(groups)), g] = 1.0
    Mavg /= Mavg.sum(0, keepdim=True)
    val = torch.where(fm, fv, torch.round(torch.clamp(
        r32.x[:, bidx] @ Mavg, 0.0, 1.0))[:, g])
    lbp, ubp = lb.clone(), ub.clone()
    lbp[:, bidx], ubp[:, bidx] = val, val
    pw = (r32.x, r32.z, r32.y)

    def probe(k, k2, q):
        a = solve(k2, q, h, lbp, ubp, 200, pw)
        return a, solve(k, q, h, lbp, ubp, 200, (a.x, a.z, a.y))

    p32, p64 = probe(kq, kq2, f), probe(kd, kd2, f)
    out["probe, 200 it at rho*10 warm"] = _errors(p32[0], p64[0])
    out["probe, then 200 it at rho"] = _errors(p32[1], p64[1])
    out["probe, one ulp of q (float32 both)"] = _errors(
        probe(kq, kq2, f * (1 + 2.0 ** -23))[1], p32[1])
    out["probe converged share (r_prim_rel < 1e-3)"] = float(
        (p32[1].r_prim_rel < 1e-3).float().mean())
    return out


def _double_tree(swt):
    """A stagewise tree prep in float64 (its own operator cache)."""
    from pyhybridcontrol_tpu_torch.ops.stagewise import stagewise_double

    return dataclasses.replace(swt, sw=stagewise_double(swt.sw),
                               M=swt.M.double(),
                               probs=swt.probs.double(),
                               omega=swt.omega.double())


def stagewise_readings(seed=5):
    """{stage: {field: error}} of float32 against float64 on config 6's
    stagewise wave (see the module docstring)."""
    import chip_smoke as cs

    from pyhybridcontrol_tpu_torch.ops.stagewise_tree import (
        StagewiseTreeBackend, assemble_stagewise_tree_ext)

    tree_l = cs.config6_trees()[1]
    swt, swtp = cs.config6_preps("cpu", tree_l, cs.config6_extra(cs.CFG6_N))
    x0 = torch.tensor(cs.X0_6)
    eu = assemble_stagewise_tree_ext(swt, x0)
    be, fb, hb, lb, ub = cs.node_wave(swt, eu, np.random.default_rng(seed),
                                      cs.CFG6_SPEC["wave_size"],
                                      cs.K4_HOLD_FIX)
    be64 = StagewiseTreeBackend(_double_tree(swt), ext_u=eu.double())
    bp = StagewiseTreeBackend(swtp, ext_u=eu)
    bp64 = StagewiseTreeBackend(_double_tree(swtp), ext_u=eu.double())
    iters, piters = cs.CFG6_SPEC["qp_iters"], cs.CFG6_SPEC["probe_iters"]
    d = tuple(a.double() for a in (fb, hb, lb, ub))
    out = {}
    r32 = be.solve(fb, hb, lb, ub, iters)
    out[f"relaxation, {iters} it"] = _errors(r32, be64.solve(*d, iters))
    reps = torch.as_tensor(be.binary_idx)
    pv = torch.round(torch.clamp(r32.x[:, reps], 0.0, 1.0))
    lbp, ubp = lb.clone(), ub.clone()
    lbp[:, reps] = ubp[:, reps] = pv
    warm = (r32.x, r32.z, r32.y)
    p32 = bp.solve(fb, hb, lbp, ubp, piters, warm=warm)
    p64 = bp64.solve(fb.double(), hb.double(), lbp.double(), ubp.double(),
                     piters, warm=tuple(w.double() for w in warm))
    out[f"probe, {piters} it at rho*10 warm"] = _errors(p32, p64)
    out["probe, one ulp of q (float32 both)"] = _errors(
        bp.solve(fb * (1 + 2.0 ** -23), hb, lbp, ubp, piters, warm=warm),
        p32)
    out["probe converged share (r_prim_rel < 1e-3)"] = float(
        (p32.r_prim_rel < 1e-3).float().mean())
    return out


def flex_readings(seed=5):
    """{shape and stage: {field: error}} of float32 against float64 at the
    FLEX variants' shapes (see the module docstring)."""
    import chip_smoke as cs

    return _k5_wave_readings(
        ((w[0],) + tuple(w[2:7]) for w in cs.flex_waves(
            torch.device("cpu"), np.random.default_rng(seed))),
        windowed=True)


def any_readings(seed=5):
    """The same at K5's shapes past its register path (``--any``)."""
    import chip_smoke as cs

    return _k5_wave_readings(
        w[:6] for w in cs.any_waves(torch.device("cpu"),
                                    np.random.default_rng(seed)))


def _k5_wave_readings(waves, windowed=False):
    """{shape and stage: {field: error}}: for each (tag, backend, f, h, lb,
    ub) of ``waves``, the plain loop's relaxation (K5_RELAX iterations,
    cold, float32), then FLEX_HOLD_ITERS iterations from it in float32
    against float64, and again after a one-ulp change of q; ``windowed``:
    where the horizon variant takes the shape, both also with
    ``_solve_K_windowed`` on its plan's windows."""
    import chip_smoke as cs

    from pyhybridcontrol_tpu_torch.ops import cuda_stagewise as cst
    from pyhybridcontrol_tpu_torch.ops import stagewise as tsw

    floor = dict(cs.FLOOR)
    names = ("x", "z", "y", "dy", "z_e", "y_e", "dy_e")

    def errors(got, ref):
        return {k: float(((g.double() - r.double()).abs()
                          / r.double().abs().clamp_min(floor[k])).max())
                for k, g, r in zip(names, got, ref) if g is not None}

    def double(args):
        a = [t.double() if isinstance(t, torch.Tensor) else t for t in args]
        a[0] = tsw.stagewise_double(args[0])
        return tuple(a)

    orig, calls = tsw._admm_iterations, []

    def record(*a, **kw):
        calls.append(a)
        return orig(*a, **kw)

    out = {}
    for tag, be, fb, hb, lb, ub in waves:
        calls.clear()
        tsw._admm_iterations = record
        try:
            be.solve(fb, hb, lb, ub, cs.K5_RELAX)
        finally:
            tsw._admm_iterations = orig
        args = calls[0]
        held = cs.with_warm(args, orig(*args), cs.FLEX_HOLD_ITERS)
        r32 = orig(*held)
        out[f"{tag}, {cs.FLEX_HOLD_ITERS} it warm"] = errors(
            r32, orig(*double(held)))
        a = list(held)
        a[1] = held[1] * (1 + 2.0 ** -23)
        out[f"{tag}, one ulp of q (float32 both)"] = errors(orig(*a), r32)
        sw = args[0]
        mean = args[11] is not None and sw.n_cons > 0
        if not (windowed and cst.horizon_applies(sw.b, mean=mean,
                                                 n_ext=sw.n_ext)):
            continue
        P = args[1].numel() // (sw.N * sw.b)
        C = cst.plan_admm(P, sw.N, sw.b, sw.m_k, parallel=True,
                          device=args[1].device).cluster
        win = cst.horizon_windows(sw.N, C)

        def sweep(s, t):
            return tsw._solve_K_windowed(s, t, win)

        r32 = orig(*held, sweep=sweep)
        out[f"{tag}, {cs.FLEX_HOLD_ITERS} it warm, {C} windows"] = errors(
            r32, orig(*double(held), sweep=sweep))
        out[f"{tag}, {C} windows, one ulp of q (float32 both)"] = errors(
            orig(*a, sweep=sweep), r32)
    return out


def served_readings(seed=5, B=64, iters=400):
    """{stage: {field: error}} of float32 against float64 on the served
    config-2 request's relaxation (see the module docstring)."""
    import chip_smoke as cs

    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca

    spec, _, _, f, h, lb, ub = cs.real_problem(
        "config2", B, "cpu", np.random.default_rng(seed))
    kq = ca.kernel_qp_for(spec)
    kd = _double(kq)
    cold = ca.admm_solve_plain(kq, f, h, lb, ub, iters=iters)
    warm = (cold.x, cold.z, cold.y)
    r32 = ca.admm_solve_plain(kq, f, h, lb, ub, iters=iters, warm=warm)
    r64 = ca._solve_plain(kd, f.double(), h.double(), lb.double(),
                          ub.double(), iters, 0,
                          tuple(w.double() for w in warm))
    r1 = ca.admm_solve_plain(kq, f * (1 + 2.0 ** -23), h, lb, ub,
                             iters=iters, warm=warm)
    bidx = torch.as_tensor(cs.bench_frame("config2")[2].binary_idx)

    def rounded(res):
        return torch.round(torch.clamp(torch.clamp(
            res.x[:, bidx], lb[:, bidx], ub[:, bidx]), 0.0, 1.0))

    def flips(a, b):
        d = rounded(a) != rounded(b)
        return float(d.any(-1).float().mean())

    return {f"relaxation, {iters} it warm": _errors(r32, r64),
            "relaxation, one ulp of q (float32 both)": _errors(r1, r32),
            "share of instances rounding a binary otherwise, float32 vs "
            "float64": flips(r32, r64),
            "the same, one ulp of q (float32 both)": flips(r1, r32)}


def decentralized_readings(seed=0):
    """{stage: errors or count} of K2's plain version in float32 against
    float64 on the decentralized agents' wave (see the module
    docstring)."""
    import chip_smoke as cs

    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca

    cs.SEED = seed
    rng = cs.phase_rng("surface_shapes")
    for name, B, *_ in cs.SURFACE_SHAPES[:2]:     # the draws before it
        cs.surface_problem(name, B, "cpu", rng)
    name, B, iters, piters, *_ = cs.SURFACE_SHAPES[2]
    spec, _, bidx, f, h, lb, ub = cs.surface_problem(name, B, "cpu", rng)
    kq = ca.kernel_qp_for(spec)
    kd = _double(kq)
    kw = dict(iters=iters, probe_iters=piters)
    cold = ca.admm_wave_plain(kq, None, bidx, f, h, lb, ub, **kw)
    warm = (cold[0].x, cold[0].z, cold[0].y)
    r32 = ca.admm_wave_plain(kq, None, bidx, f, h, lb, ub, warm=warm, **kw)
    r64 = ca.admm_wave_plain(kd, None, bidx, f.double(), h.double(),
                             lb.double(), ub.double(),
                             warm=tuple(w.double() for w in warm), **kw)
    b = torch.as_tensor(bidx)

    def rounded(res):
        return torch.round(torch.clamp(torch.clamp(
            res.x[:, b].float(), lb[:, b], ub[:, b]), 0.0, 1.0))

    out = {"relaxation, float32 vs float64": _errors(r32[0], r64[0]),
           "instances rounding a binary otherwise": float(
               (rounded(r32[0]) != rounded(r64[0])).any(-1).sum())}
    for i, stage in ((0, "relaxation"), (1, "probe")):
        differ = r32[i].infeas_cert != r64[i].infeas_cert
        near = cs.cert_near((kq, f, h, lb, ub), r32[i],
                            None if i == 0 else bidx)
        out[f"{stage}: certificate bits that differ"] = float(differ.sum())
        out[f"{stage}: of those outside CERT_BAND"] = float(
            (differ & ~near).sum())
    return out


def strong_branching_readings(seed=0):
    """{stage: errors or count} of K1's plain version in float32 against
    float64 on the strong-branching batch (see the module docstring)."""
    import chip_smoke as cs

    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca

    cs.SEED = seed
    rng = cs.phase_rng("sb_batch")
    x0 = (cs.CFG2_X0 if seed == 0
          else rng.uniform(*cs.TRUST_BOX).astype(np.float32).tolist())
    st = cs.cfg2_setup("cpu")
    q, h, lb, ub, warm = cs.sb_batch(st, torch.tensor(x0))
    kq = ca.kernel_qp_for(st.admm)
    iters = cs.CFG2_SB["sb_iters"]
    r32 = ca.admm_solve_plain(kq, q, h, lb, ub, iters=iters, warm=warm)
    r64 = ca._solve_plain(_double(kq), q.double(), h.double(), lb.double(),
                          ub.double(), iters, 0,
                          tuple(w.double() for w in warm))
    return {f"candidates, {iters} it warm, x0={x0}": _errors(r32, r64),
            "certificate bits set (float32)": float(r32.infeas_cert.sum()),
            "certificate bits that differ": float(
                (r32.infeas_cert != r64.infeas_cert).sum())}


def _wave_readings(problem, iters, piters, warm_start):
    """{stage: errors or count} of K2's plain version in float32 against
    float64 on the wave of ``problem`` (``chip_smoke.real_problem``'s
    tuple), warm from a cold wave or cold."""
    import chip_smoke as cs

    from pyhybridcontrol_tpu_torch.ops import admm as tadmm
    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca

    spec, spec_p, bidx, f, h, lb, ub = problem
    kq, kq2 = ca.kernel_qp_for(spec), ca.kernel_qp_for(spec_p)
    kw = dict(iters=iters, probe_iters=piters)
    warm = None
    if warm_start:
        cold = ca.admm_wave_plain(kq, kq2, bidx, f, h, lb, ub, **kw)
        warm = (cold[0].x, cold[0].z, cold[0].y)
    r32 = ca.admm_wave_plain(kq, kq2, bidx, f, h, lb, ub, warm=warm, **kw)
    r64 = ca.admm_wave_plain(_double(kq), _double(kq2), bidx, f.double(),
                             h.double(), lb.double(), ub.double(),
                             warm=None if warm is None
                             else tuple(w.double() for w in warm), **kw)
    b = torch.as_tensor(bidx)

    def rounded(res):
        return torch.round(torch.clamp(torch.clamp(
            res.x[:, b].float(), lb[:, b], ub[:, b]), 0.0, 1.0))

    differ = rounded(r32[0]) != rounded(r64[0])
    same = ~differ.any(-1)
    out = {"relaxation": _errors(r32[0], r64[0]),
           "probe (instances rounding alike)": _errors(*(
               tadmm.AdmmResult(**{k: None if v is None else v[same]
                                   for k, v in vars(r).items()})
               for r in (r32[1], r64[1]))),
           "instances rounding a binary otherwise": float((~same).sum()),
           "the farthest such binary from 0.5": float(
               (r64[0].x[:, b][differ] - 0.5).abs().max()) if bool(
                   differ.any()) else 0.0}
    for i, stage in ((0, "relaxation"), (1, "probe")):
        bits = r32[i].infeas_cert != r64[i].infeas_cert
        out[f"{stage}: certificate bits that differ"] = float(bits.sum())
        if bool(bits.any()):
            factor = cs.cert_factor((kq, f, h, lb, ub), r32[i],
                                    None if i == 0 else bidx)
            out[f"{stage}: the farthest within this factor of its "
                f"threshold"] = float(factor[bits].max())
    return out


def path_wave_readings(seed, only=None):
    """``_wave_readings`` at phase 9's path shapes
    (``chip_smoke.PATH_SHAPES``; ``only``: the one of that (name, B)),
    drawn as the phase draws them."""
    import chip_smoke as cs

    cs.SEED = seed
    rng = cs.phase_rng("streamed_paths")
    out = {}
    for shape in cs.PATH_SHAPES:
        problem = cs.real_problem(shape[0], shape[1], "cpu", rng)
        if only in (None, shape[:2]):
            for k, v in _wave_readings(problem, shape[2], shape[3],
                                       True).items():
                out[f"{shape[0]} B={shape[1]}, {k}"] = v
        if only == shape[:2]:
            break
    return out


def big_shape_readings(seed, B=300):
    """``_wave_readings`` at phase 9's B=300 shapes of the real frames with
    certificate rules (configs 3, 4b, 2), drawn as the phase draws them."""
    import chip_smoke as cs

    cs.SEED = seed
    rng = cs.phase_rng("streamed")
    out = {}
    for name, (n, m) in cs.BIG_SHAPES.items():
        for b in cs.BIG_BATCHES:
            problem = (cs.real_problem(name, b, "cpu", rng)
                       if name in cs.REAL_CONFIGS
                       else cs.random_problem(n, m, b, "cpu", rng))
            if b == B and name in cs.CERT_FRAMES:
                for k, v in _wave_readings(problem, 100, 100,
                                           False).items():
                    out[f"{name} B={B}, {k}"] = v
    return out


def one_pass_readings(seed=0):
    """{stage: errors} of the split phase against itself after a one-ulp
    change of q, one pass and three (see the module docstring)."""
    import chip_smoke as cs

    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca

    cs.SEED = seed
    rng = cs.phase_rng("mixed_schedule")
    out = {}
    for N in (20, 27):
        _, _, spec, _, f, h, lb, ub = cs.problem(N, 4096, "cpu", rng)
        kq = ca.kernel_qp_for(spec)
        for passes in (1, 3):
            a, b = (ca.admm_solve_plain(kq, q, h, lb, ub, iters=100,
                                        low_frac=1.0, lo_passes=passes)
                    for q in (f, f * (1 + 2.0 ** -23)))
            out[f"N={N}, {passes} pass(es), one ulp of q"] = {
                k: v for k, v in _errors(a, b).items() if k in ("obj", "x")}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=300)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--stagewise", action="store_true")
    ap.add_argument("--served", action="store_true")
    ap.add_argument("--decentralized", action="store_true")
    ap.add_argument("--strong-branching", action="store_true")
    ap.add_argument("--config4b", action="store_true")
    ap.add_argument("--one-pass", action="store_true")
    ap.add_argument("--paths", action="store_true")
    ap.add_argument("--big-shapes", action="store_true")
    ap.add_argument("--flex", action="store_true")
    ap.add_argument("--any", action="store_true")
    a = ap.parse_args(argv)
    torch.set_num_threads(4)
    got = (stagewise_readings(a.seed) if a.stagewise
           else flex_readings(a.seed) if a.flex
           else any_readings(a.seed) if a.any
           else served_readings(a.seed) if a.served
           else decentralized_readings(a.seed) if a.decentralized
           else strong_branching_readings(a.seed) if a.strong_branching
           else path_wave_readings(a.seed, ("config4b", 1024)) if a.config4b
           else path_wave_readings(a.seed) if a.paths
           else big_shape_readings(a.seed) if a.big_shapes
           else one_pass_readings(a.seed) if a.one_pass
           else readings(a.batch, a.seed))
    for stage, errs in got.items():
        if isinstance(errs, float):
            print(f"{stage}: {errs:.3g}")
        else:
            print(f"{stage}: " + " ".join(f"{k}={v:.2e}"
                                          for k, v in errs.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
