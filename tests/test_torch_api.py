"""The port's public surface against the JAX package's: every public name
has a counterpart or a recorded decision (parsed with ``ast``, so nothing
of JAX is imported for it), and the entry points added last hold the JAX
package's results on the same inputs, made from numpy seeds, on the CPU.

Tolerances: ``prepare_admm``'s arrays within 1e-6 relative (the same host
fp64 arithmetic, rounded to fp32 once); ``admm_solve_batch`` as
tests/test_torch_admm.py holds the plain path against the reference's
(objective 1e-4 relative with a floor of 1, x and z 1e-3); the mixed
schedule within the JAX package's own tolerance for it
(tests/test_qp_solvers.py::test_admm_mixed_precision_schedule: objective
rtol/atol 1e-3, r_prim_rel below 5e-3), because the reference's XLA on
the CPU multiplies in exact fp32 whatever the precision while the port's
plain version makes the bf16 passes; the port's own schedules bitwise
where they run the same arithmetic."""

import ast
import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyhybridcontrol_tpu.models.double_integrator as jdi
from pyhybridcontrol_tpu.ops import admm as jadmm
from pyhybridcontrol_tpu.ops.condense import CondensedMpc as JCondensed
from pyhybridcontrol_tpu.utils import structdict as jsd
from pyhybridcontrol_tpu_torch import convert
from pyhybridcontrol_tpu_torch.ops import admm as tadmm
from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca
from pyhybridcontrol_tpu_torch.utils import structdict as tsd

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JAX, _PORT = "pyhybridcontrol_tpu", "pyhybridcontrol_tpu_torch"

# ---- the name-parity table ----------------------------------------------

# What the port lacks by decision, each with its reason and where
# ROADMAP.md records it ("Decisions" under "Ported so far"). Keys:
# (module, name, member): a whole module (name None), a keyword argument of
# a function or method ("Class.method" names a method), or a method or
# dataclass field of a class; "*" stands for every function of the module.
DECIDED = {
    ("utils/dd.py", None, None):
        "double-float sums: the card has fp64, certificate sums are "
        "float64 (ROADMAP.md, 'What changes on Hopper')",
    ("utils/prepcache.py", None, None):
        "no jit caches to guard; derived data memoized on the spec "
        "(ROADMAP.md, decision on utils/prepcache.py)",
    ("ops/admm.py", "BoxQP", "pallas_mode"):
        "dispatch follows the tensor's device (ROADMAP.md, decision on "
        "pallas_mode)",
    ("ops/admm.py", "prepare_admm", "pallas_mode"):
        "dispatch follows the tensor's device (ROADMAP.md, decision on "
        "pallas_mode)",
    ("ops/admm.py", "prepare_admm", "dtype"):
        "the port's frames are fp32 (ROADMAP.md, decision on dtype)",
    ("mld/model.py", "MldModel.from_matrices", "dtype"):
        "the port's frames are fp32 (ROADMAP.md, decision on dtype)",
    ("mld/symbolic.py", "from_sympy", "dtype"):
        "the port's frames are fp32 (ROADMAP.md, decision on dtype)",
    ("ops/stagewise.py", "prepare_stagewise", "dtype"):
        "the port's frames are fp32 (ROADMAP.md, decision on dtype)",
    ("utils/matrix_utils.py", "*", "xp"):
        "host assembly is numpy alone, device code torch (ROADMAP.md, "
        "decision on xp)",
    ("parallel/mesh.py", "make_mesh", "devices"):
        "ranks pick their card by rank, device_type names the kind "
        "(ROADMAP.md, decision on make_mesh)",
    ("solver/bnb.py", "BnbState", "wave"):
        "the wave loop is a Python loop that counts its own waves "
        "(ROADMAP.md, decision on the wave loop)",
    ("solver/bnb_pooled.py", "PooledState", "wave"):
        "the wave loop is a Python loop that counts its own waves "
        "(ROADMAP.md, decision on the wave loop)",
}
# the Pallas module's counterpart and its renamed entry points; the Pallas
# launch options (a lane tile, interpret mode) are the plan's pb, streamed
# and cluster there (ROADMAP.md, decision on pallas_mode)
RENAMED = {"ops/pallas_admm.py": ("ops/cuda_admm.py", {
    "PallasQP": "KernelQP", "prepare_pallas": "prepare_kernel_qp",
    "pallas_for": "kernel_qp_for", "admm_solve_pallas": "admm_solve_cuda",
    "admm_wave_pallas": "admm_wave_cuda"}, ("tile", "interpret"))}


def _keywords(fn: ast.FunctionDef, defaulted: bool):
    """Parameter names of ``fn``: those with a default and the keyword-only
    ones (``defaulted``), or every one."""
    a = fn.args
    pos = a.posonlyargs + a.args
    if defaulted:
        pos = pos[len(pos) - len(a.defaults):]
    return {p.arg for p in pos + a.kwonlyargs}


def _module_surface(path, pkg):
    """Top-level bindings of one module: functions (their keywords),
    classes (bases, methods with keywords, dataclass fields), and names
    bound otherwise (assignments, imports from the package: an alias to
    (module, name) where it can be followed)."""
    tree = ast.parse(open(path, encoding="utf-8").read())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            out[node.name] = ("function", node)
        elif isinstance(node, ast.ClassDef):
            methods = {b.name: b for b in node.body
                       if isinstance(b, ast.FunctionDef)}
            fields = {b.target.id for b in node.body
                      if isinstance(b, ast.AnnAssign)
                      and isinstance(b.target, ast.Name)}
            bases = [b.id for b in node.bases if isinstance(b, ast.Name)]
            out[node.name] = ("class", methods, fields, bases)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    src = (node.value.id if isinstance(node.value, ast.Name)
                           else None)
                    out[t.id] = ("alias", None, src)
        elif isinstance(node, ast.ImportFrom) and node.module and (
                node.module == pkg or node.module.startswith(pkg + ".")):
            rel = node.module[len(pkg) + 1:].replace(".", "/")
            for al in node.names:
                out[al.asname or al.name] = ("alias", rel, al.name)
    return out


def _package_surface(pkg):
    root = os.path.join(_REPO, pkg)
    mods = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                rel = os.path.relpath(path, root).replace(os.sep, "/")
                mods[rel] = _module_surface(path, pkg)
    return mods


def _resolve(mods, mod, name, depth=0):
    """The function or class that ``name`` of module ``mod`` binds,
    following aliases and imports inside the package (None where it binds
    something else)."""
    item = mods.get(mod, {}).get(name)
    if item is None or depth > 8:
        return None
    if item[0] != "alias":
        return item
    _, src_mod, src = item
    if src is None:
        return None
    for cand in ((src_mod + ".py", src_mod + "/__init__.py")
                 if src_mod else (mod,)):
        got = _resolve(mods, cand, src, depth + 1)
        if got is not None:
            return got
    return None


def _class_members(mods, mod, item, depth=0):
    """(methods, fields) of a class, its bases' inside the package
    included."""
    _, methods, fields, bases = item
    methods, fields = dict(methods), set(fields)
    for b in bases:
        base = _resolve(mods, mod, b)
        if base is not None and base[0] == "class" and depth < 8:
            m2, f2 = _class_members(mods, mod, base, depth + 1)
            methods = {**m2, **methods}
            fields |= f2
    return methods, fields


def _gaps():
    """Every public function, class, method, dataclass field and keyword
    argument of the JAX package without a counterpart in the port, as
    (module, name, member) keys of DECIDED's form."""
    jax_mods, port_mods = _package_surface(_JAX), _package_surface(_PORT)
    gaps = set()
    for mod, items in sorted(jax_mods.items()):
        pmod, renamed, launch_opts = RENAMED.get(mod, (mod, {}, ()))
        if pmod not in port_mods:
            gaps.add((mod, None, None))
            continue
        for name, item in items.items():
            if name.startswith("_") or item[0] == "alias":
                continue
            pname = renamed.get(name, name)
            if pname not in port_mods[pmod]:
                gaps.add((mod, name, None))
                continue
            got = _resolve(port_mods, pmod, pname)
            if got is None or got[0] != item[0]:
                continue      # a counterpart of another kind (an alias)
            if item[0] == "function":
                for k in (_keywords(item[1], True) - _keywords(got[1], False)
                          - set(launch_opts)):
                    gaps.add((mod, name, k))
                continue
            jm, jf = _class_members(jax_mods, mod, item)
            pm, pf = _class_members(port_mods, pmod, got)
            for f in jf - pf - set(pm):
                gaps.add((mod, name, f))
            for m, fn in jm.items():
                if m.startswith("_"):
                    continue
                if m not in pm:
                    gaps.add((mod, name, m))
                    continue
                for k in _keywords(fn, True) - _keywords(pm[m], False):
                    gaps.add((mod, f"{name}.{m}", k))
    return gaps


def _decided(key):
    mod, name, member = key
    return key in DECIDED or (mod, "*", member) in DECIDED


def test_every_public_name_has_a_counterpart():
    """Module by module, every public top-level function and class of the
    JAX package has a counterpart in the port under its name (or its
    renamed one, RENAMED), with every public method, dataclass field and
    keyword argument; what is missing is missing by a recorded decision
    (DECIDED), and every decision still stands for a real gap."""
    gaps = _gaps()
    undecided = sorted(k for k in gaps if not _decided(k))
    assert not undecided, f"no counterpart and no decision: {undecided}"
    stale = sorted(k for k in DECIDED if not (
        k in gaps or (k[1] == "*" and any(
            g[0] == k[0] and g[2] == k[2] for g in gaps))))
    assert not stale, f"decisions for names the port has: {stale}"


def test_parity_scan_sees_a_missing_name(tmp_path, monkeypatch):
    """The scan is not vacuous: a JAX-side function the port lacks, a
    keyword argument it lacks and a dataclass field it lacks all show."""
    jmod = _module_surface(os.path.join(_REPO, _JAX, "ops", "admm.py"), _JAX)
    assert "admm_solve_mixed" in jmod and "BoxQP" in jmod
    assert {"rho_eq_scale", "boost_scale", "dd_cert", "precision"} <= \
        _keywords(jmod["prepare_admm"][1], True)
    src = "def admm_solve(spec, q, h, lb, ub, iters=100):\n    pass\n"
    (tmp_path / "ops").mkdir()
    (tmp_path / "ops" / "admm.py").write_text(src)
    fake = _module_surface(str(tmp_path / "ops" / "admm.py"), _PORT)
    assert "warm" in (_keywords(jmod["admm_solve"][1], True)
                      - _keywords(fake["admm_solve"][1], False))


# ---- StructDict ----------------------------------------------------------


def test_structdict_copy_keeps_the_type_and_the_old_copy_did_not():
    """``copy`` returns a StructDict as the JAX package's does (attribute
    access kept). The port's StructDict used to inherit ``dict.copy``,
    which gives a plain dict: ``.a`` raised where the reference reads 1."""
    j, t = jsd.StructDict(a=1, b=2), tsd.StructDict(a=1, b=2)
    assert j.copy().a == t.copy().a == 1
    assert type(t.copy()) is tsd.StructDict
    old = dict.copy(t)                      # what the port's copy was
    assert type(old) is dict
    with pytest.raises(AttributeError):
        old.a


def test_structdict_update_new_and_sub_struct_match_reference():
    j, t = jsd.StructDict(a=1, b=2, c=3), tsd.StructDict(a=1, b=2, c=3)
    ju, tu = j.update_new(b=5, d=6), t.update_new(b=5, d=6)
    assert dict(tu) == dict(ju) == {"a": 1, "b": 5, "c": 3, "d": 6}
    assert dict(t) == {"a": 1, "b": 2, "c": 3}       # the original kept
    assert type(tu) is tsd.StructDict and tu.d == 6
    js, ts = j.sub_struct(["c", "a"]), t.sub_struct(["c", "a"])
    assert dict(ts) == dict(js) == {"a": 1, "c": 3}
    assert type(ts) is tsd.StructDict
    with pytest.raises(KeyError):
        t.sub_struct(["z"])


def test_named_struct_dict_matches_reference():
    """Positional arguments map onto the fields in order, keywords follow,
    too many positional arguments raise TypeError; the type name and the
    fields survive copy, update_new and sub_struct."""
    from pyhybridcontrol_tpu_torch import named_struct_dict
    from pyhybridcontrol_tpu_torch.utils import (
        named_struct_dict as from_utils)

    assert named_struct_dict is from_utils is tsd.named_struct_dict
    J = jsd.named_struct_dict("Weights", "Q", "R")
    T = tsd.named_struct_dict("Weights", "Q", "R")
    j, t = J(1.0, 2.0, S=3.0), T(1.0, 2.0, S=3.0)
    assert dict(t) == dict(j) == {"Q": 1.0, "R": 2.0, "S": 3.0}
    assert list(t) == list(j) == ["Q", "R", "S"]
    assert T._fields == J._fields == ("Q", "R")
    assert type(t).__name__ == "Weights" and isinstance(t, tsd.StructDict)
    assert t.R == 2.0 and repr(t) == "Weights(Q=1.0, R=2.0, S=3.0)"
    # the fields themselves, not the reference's result: its named class
    # maps the one dict that copy and sub_struct pass onto the first field
    for op, want in ((lambda s: s.copy(), {"Q": 1.0, "R": 2.0, "S": 3.0}),
                     (lambda s: s.update_new(R=4.0),
                      {"Q": 1.0, "R": 4.0, "S": 3.0}),
                     (lambda s: s.sub_struct(["R"]), {"R": 2.0})):
        got = op(t)
        assert type(got) is T and type(got).__name__ == "Weights"
        assert dict(got) == want
    P = tsd.named_struct_dict("P", "a", "b")
    assert type(P(1, 2).copy()) is P and dict(P(1, 2).copy()) == {"a": 1,
                                                                   "b": 2}
    assert dict(P(1, 2).sub_struct(["b"])) == {"b": 2}
    assert type(P(1, 2).sub_struct(["b"])) is P
    assert dict(T(1.0)) == dict(J(1.0)) == {"Q": 1.0}
    for C in (J, T):
        with pytest.raises(TypeError, match="at most 2 positional"):
            C(1.0, 2.0, 3.0)


# ---- prepare_admm's keyword arguments ------------------------------------


def test_prepare_admm_scales_and_keywords_match_reference():
    """rho_eq_scale and boost_scale on a frame with binary box rows and
    big-M product rows (the PWA spring, big-M, N=3): ρ, K⁻¹ and the
    scalings within 1e-6 relative of the JAX package's; the defaults are
    the module constants; dd_cert and precision are carried on the spec."""
    from pyhybridcontrol_tpu.models.pwa_examples import (
        pwa_spring_mld, pwa_weights)

    jc = JCondensed(pwa_spring_mld(on_off=True, formulation="bigm"), 3,
                    pwa_weights())
    tc = convert.condensed(jc)
    assert len(jc.z_rows) and len(jc.binary_idx)
    kw = dict(rho_eq_scale=4.0, boost_scale=12.0)
    js = jadmm.prepare_admm_mpc(jc, **kw)
    ts = tadmm.prepare_admm_mpc(tc, device="cpu", **kw)
    for k in ("rho_vec", "Kinv", "D", "E", "cost_scale", "P", "A"):
        want = np.asarray(getattr(js, k), np.float64)
        got = getattr(ts, k).numpy().astype(np.float64)
        err = np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30))
        assert err <= 1e-6, (k, err)
    rho = ts.rho_vec.numpy()
    m = ts.m_ineq
    assert set(np.unique(rho[m + np.asarray(tc.binary_idx)])) == {4.0}
    assert set(np.unique(rho[np.asarray(tc.z_rows)])) == {12.0}
    dflt = tadmm.prepare_admm_mpc(tc, device="cpu")
    assert set(np.unique(dflt.rho_vec.numpy()[np.asarray(tc.z_rows)])) == {
        tadmm.BOOST_SCALE}
    assert tadmm.RHO_EQ_SCALE == 10.0 and tadmm.BOOST_SCALE == 30.0
    s = tadmm.prepare_admm_mpc(tc, device="cpu", dd_cert=True,
                               precision="default")
    assert s.dd_cert is True and s.precision == "default"
    assert torch.equal(s.Kinv, dflt.Kinv)
    with pytest.raises(ValueError, match="precision"):
        tadmm.prepare_admm_mpc(tc, device="cpu", precision="bf16")


# ---- admm_solve_batch and admm_solve_mixed -------------------------------


@pytest.fixture(scope="module")
def prob():
    """N=6 double integrator, 16 seeded states, B&B-node boxes (a seeded
    third of the binaries fixed), prepared by the JAX package and carried
    across."""
    rng = np.random.default_rng(5)
    c = JCondensed(jdi.switched_double_integrator(), 6,
                   jdi.default_weights())
    jq, js = c.device_qp(), jadmm.prepare_admm_mpc(c)
    B = 16
    x0s = rng.normal(scale=2.0, size=(B, 2)).astype(np.float32)
    f, h = (np.stack([np.asarray(a) for a in fh]) for fh in
            zip(*[jq.assemble(jnp.asarray(x)) for x in x0s]))
    lb = np.broadcast_to(np.asarray(jq.lb), (B, jq.n)).copy()
    ub = np.broadcast_to(np.asarray(jq.ub), (B, jq.n)).copy()
    bidx = np.asarray(jq.binary_idx)
    fm = rng.uniform(size=(B, len(bidx))) < 0.35
    fv = (rng.uniform(size=(B, len(bidx))) < 0.5).astype(np.float32)
    lb[:, bidx] = np.where(fm, fv, 0.0)
    ub[:, bidx] = np.where(fm, fv, 1.0)
    return dict(js=js, ts=convert.box_qp(js, "cpu"), bidx=bidx,
                data=(f.astype(np.float32), h.astype(np.float32), lb, ub))


def _obj_close(t, j, rtol, atol):
    np.testing.assert_allclose(t.obj.numpy(), np.asarray(j.obj), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("one_d", [True, False])
def test_admm_solve_batch_matches_reference(prob, one_d):
    """A 1-D q (and h) broadcast to lb's batch, or a 2-D q: the port's σ=0
    batch (K1's plain version here) against the JAX package's σ-form
    admm_solve_batch, 300 iterations, where both have converged."""
    f, h, lb, ub = prob["data"]
    if one_d:
        f, h = f[0], h[0]
    jr = jadmm.admm_solve_batch(prob["js"], *map(jnp.asarray, (f, h, lb, ub)),
                                iters=300)
    tr = tadmm.admm_solve_batch(prob["ts"], *map(torch.as_tensor,
                                                 (f, h, lb, ub)), iters=300)
    assert tr.x.shape == (lb.shape[0], lb.shape[1])
    scale = np.maximum(1.0, np.abs(np.asarray(jr.obj)))
    assert np.all(np.abs(tr.obj.numpy() - np.asarray(jr.obj)) <= 1e-4 * scale)
    for k in ("x", "z"):
        np.testing.assert_allclose(getattr(tr, k).numpy(),
                                   np.asarray(getattr(jr, k)), rtol=1e-3,
                                   atol=1e-3, err_msg=k)
    want = ca.admm_solve_auto(prob["ts"], *map(torch.as_tensor, (
        np.broadcast_to(f, (lb.shape[0], f.shape[-1])).copy(),
        np.broadcast_to(h, (lb.shape[0], h.shape[-1])).copy(), lb, ub)),
        iters=300)
    assert torch.equal(tr.x, want.x) and torch.equal(tr.obj, want.obj)


def _random_qp(rng, B, n=16, m=24, cond=10.0):
    """tests/test_qp_solvers.py's random QP (origin strictly feasible), with
    B seeded linear terms."""
    U = np.linalg.qr(rng.normal(size=(n, n)))[0]
    H = U @ np.diag(np.logspace(0, np.log10(cond), n)) @ U.T
    f = rng.normal(size=(B, n))
    G = rng.normal(size=(m, n))
    h = rng.uniform(0.5, 2.0, size=m)
    lb, ub = np.full((B, n), -3.0), np.full((B, n), 3.0)
    return H, G, (f, np.broadcast_to(h, (B, m)), lb, ub)


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("low_frac", [0.0, 0.8, 1.0])
def test_admm_solve_mixed_matches_reference(low_frac, warm):
    """The two-phase schedule (200 iterations, 3-pass bf16 then full
    precision) against the JAX package's admm_solve_mixed on
    tests/test_qp_solvers.py's random QPs, cold and warm from each
    package's own 50-iteration solve; at k ∈ {0, iters} the port's full
    solve bitwise."""
    rng = np.random.default_rng(7)
    H, G, data = _random_qp(rng, 8)
    js, ts = jadmm.prepare_admm(G, H), tadmm.prepare_admm(G, H, device="cpu")
    jd = tuple(jnp.asarray(a, jnp.float32) for a in data)
    td = tuple(torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32)
               for a in data)
    jw = tw = None
    if warm:
        r0 = jadmm.admm_solve(js, *jd, iters=50)
        jw = (r0.x, r0.z, r0.y)
        t0 = ca.admm_solve_auto(ts, *td, iters=50)
        tw = (t0.x, t0.z, t0.y)
    jr = jadmm.admm_solve_mixed(js, *jd, iters=200, low_frac=low_frac,
                                warm=jw)
    tr = tadmm.admm_solve_mixed(ts, *td, iters=200, low_frac=low_frac,
                                warm=tw)
    _obj_close(tr, jr, 1e-3, 1e-3)
    assert float(tr.r_prim_rel.max()) < 5e-3
    full = ca.admm_solve_auto(ts, *td, iters=200, warm=tw)
    same = all(torch.equal(getattr(tr, k), getattr(full, k))
               for k in ("x", "z", "y", "obj"))
    assert same == (low_frac in (0.0, 1.0))


def test_admm_solve_mixed_is_one_k1_call_equal_to_two_chained(prob):
    """The schedule's one K1 call with iters_lo = k gives what two chained
    K1 calls give (the σ=0 iteration carries no x, so (z, y) is the whole
    state): bf16 phase, then the full-precision tail warm from it, to fp32
    rounding of the products' padding (1e-6)."""
    ts = prob["ts"]
    td = tuple(map(torch.as_tensor, prob["data"]))
    one = tadmm.admm_solve_mixed(ts, *td, iters=100, low_frac=0.8)
    kq = ca.kernel_qp_for(ts)
    r1 = ca.admm_solve_plain(kq, *td, iters=80, low_frac=1.0)
    two = ca.admm_solve_plain(kq, *td, iters=20, warm=(r1.x, r1.z, r1.y))
    for k in ("x", "z", "y", "obj"):
        a, b = getattr(one, k), getattr(two, k)
        err = float(((a - b).abs() / b.abs().clamp_min(1.0)).max())
        assert err <= 1e-6, (k, err)


def test_admm_solve_mixed_routes_on_the_specs_precision(prob, monkeypatch):
    """Where the spec itself is split, the tail keeps the spec's precision:
    two chained calls (the first all at low_precision); equal precisions
    are one solve; an unknown precision raises."""
    ts = prob["ts"]
    td = tuple(map(torch.as_tensor, prob["data"]))
    calls = []
    plain = ca.admm_solve_plain

    def spy(*a, **kw):
        calls.append((kw["iters"], kw["low_frac"], kw["lo_passes"]))
        return plain(*a, **kw)

    monkeypatch.setattr(ca, "admm_solve_plain", spy)
    hi = dataclasses.replace(ts, precision="high", cache={})
    tadmm.admm_solve_mixed(hi, *td, iters=100, low_frac=0.8,
                           low_precision="default")
    assert calls == [(80, 1.0, 1), (20, 1.0, 3)]
    calls.clear()
    tadmm.admm_solve_mixed(hi, *td, iters=100, low_frac=0.8)
    assert calls == [(100, 1.0, 3)]
    calls.clear()
    tadmm.admm_solve_mixed(ts, *td, iters=100, low_frac=0.8,
                           low_precision="default")
    assert calls == [(100, 0.8, 1)]
    with pytest.raises(ValueError, match="low_precision"):
        tadmm.admm_solve_mixed(ts, *td, low_precision="tf32")


# ---- BoxQP.precision -----------------------------------------------------

# the objective of a split-precision solve against the full-precision one
# at 300 iterations: "high" within the bench's 1e-4 gate (bench.py's mixed
# section; the readings here: 2.2e-6 through K1's plain version, 4.1e-6
# through the σ-form solve); "default", one bf16 pass (8 mantissa bits),
# within about 3x the larger of its readings, 6.4e-4 and 1.73e-3
PRECISION_OBJ = {"high": 1e-4, "default": 5e-3}


@pytest.mark.parametrize("precision", ["high", "default"])
def test_precision_runs_every_iteration_in_the_split_phase(prob, precision):
    """prepare_admm(precision=) on the port: admm_solve_auto runs every
    iteration in K1's split phase (3 or 1 passes), within PRECISION_OBJ
    of the full-precision solve and off it bitwise; the JAX package's
    solve at the same precision (exact fp32 on the CPU) within its own
    mixed tolerance for "high"."""
    ts = prob["ts"]
    td = tuple(map(torch.as_tensor, prob["data"]))
    sp = dataclasses.replace(ts, precision=precision, cache={})
    got = ca.admm_solve_auto(sp, *td, iters=300)
    full = ca.admm_solve_auto(ts, *td, iters=300)
    want = ca.admm_solve_plain(ca.kernel_qp_for(ts), *td, iters=300,
                               low_frac=1.0,
                               lo_passes=3 if precision == "high" else 1)
    assert torch.equal(got.x, want.x) and not torch.equal(got.x, full.x)
    rel = ((got.obj - full.obj).abs() / full.obj.abs().clamp_min(1.0)).max()
    assert float(rel) <= PRECISION_OBJ[precision], float(rel)
    if precision == "high":
        jp = dataclasses.replace(prob["js"], precision=precision)
        jr = jadmm.admm_solve_batch(jp, *map(jnp.asarray, prob["data"]),
                                    iters=300)
        _obj_close(got, jr, 1e-3, 1e-3)


@pytest.mark.parametrize("precision", ["high", "default"])
def test_sigma_form_solve_takes_the_specs_precision(prob, precision):
    """The σ-form admm_solve makes the bf16 passes of its iterations where
    the reference's XLA would take them from the MXU: within PRECISION_OBJ
    of its own full-precision solve, and for "high" within the JAX
    package's mixed tolerance of the reference's (exact on the CPU)."""
    ts = prob["ts"]
    td = tuple(map(torch.as_tensor, prob["data"]))
    sp = dataclasses.replace(ts, precision=precision)
    got = tadmm.admm_solve(sp, *td, iters=300)
    full = tadmm.admm_solve(ts, *td, iters=300)
    assert not torch.equal(got.x, full.x)
    rel = ((got.obj - full.obj).abs() / full.obj.abs().clamp_min(1.0)).max()
    assert float(rel) <= PRECISION_OBJ[precision], float(rel)
    if precision == "high":
        jp = dataclasses.replace(prob["js"], precision=precision)
        jr = jadmm.admm_solve(jp, *map(jnp.asarray, prob["data"]), iters=300)
        _obj_close(got, jr, 1e-3, 1e-3)


def test_a_wave_refuses_a_split_precision_spec(prob):
    """K2 has no split phase (nor has the reference's wave kernel): a wave
    on a spec whose precision is not "highest" raises, naming it."""
    ts = prob["ts"]
    td = tuple(map(torch.as_tensor, prob["data"]))
    for precision in ("high", "default"):
        sp = dataclasses.replace(ts, precision=precision, cache={})
        for a, b in ((sp, None), (ts, sp)):
            with pytest.raises(ValueError, match=precision):
                ca.admm_wave_auto(a, b, prob["bidx"], *td, iters=10,
                                  probe_iters=10)


# ---- the oracle's cvxpy cross-check, the stagewise consensus prox --------


def test_cvxpy_cross_check_returns_none_without_cvxpy(monkeypatch):
    """Import-guarded as the reference's: without cvxpy it returns None.
    Neither this machine nor the card's has cvxpy, so only this branch is
    held."""
    from pyhybridcontrol_tpu_torch.solver.oracle import cvxpy_cross_check

    monkeypatch.setitem(sys.modules, "cvxpy", None)
    H = np.eye(2)
    assert cvxpy_cross_check(H, np.zeros(2), np.zeros((1, 2)), np.ones(1),
                             -np.ones(2), np.ones(2), [1]) is None


def test_stagewise_consensus_z_matches_reference():
    """``consensus_z``, the reference's callable group-mean prox of the
    consensus rows, on the S=4, N=6 stagewise tree: the port's loop with
    the callable against the reference's (tests/test_torch_stagewise_tree
    .py's tolerances: objective 1e-4 relative, iterates 1e-3), and against
    the port's own weights tensor within fp32 rounding."""
    from pyhybridcontrol_tpu.mld.info import MldInfo as JInfo
    from pyhybridcontrol_tpu.mld.model import MldModel as JModel
    from pyhybridcontrol_tpu.ops import stagewise as jsw
    from pyhybridcontrol_tpu.ops import stagewise_tree as jst
    from pyhybridcontrol_tpu.ops.scenario_tree import ScenarioTree as JTree
    from pyhybridcontrol_tpu_torch.ops import stagewise as tsw
    from pyhybridcontrol_tpu_torch.ops import stagewise_tree as tst

    base = jdi.switched_double_integrator()
    m = base.numpy_mats()
    jm = JModel.from_matrices(
        JInfo(nx=2, nu=1, ndelta=1, nz=1, nomega=1, ny=2,
              ncons=base.info.ncons),
        A=m.A, B1=m.B1, B3=m.B3, B4=np.array([[0.0], [1.0]]), C=m.C, E=m.E,
        F1=m.F1, F2=m.F2, F3=m.F3, f5=m.f5)
    paths = np.random.default_rng(3).normal(0.0, 0.3, size=(4, 6, 1))
    jt = JTree.from_branching(paths, branch_steps=(1, 3))
    js = jst.prepare_stagewise_tree(jm, jt, jdi.default_weights())
    ts = convert.stagewise_tree_qp(js, "cpu")
    x0 = np.array([2.0, 0.0], np.float32)
    jd = jst.assemble_stagewise_tree(js, jnp.asarray(x0))
    td = tst.assemble_stagewise_tree(ts, torch.as_tensor(x0))
    jr = jsw.stagewise_admm_solve(js.sw, *jd, iters=200,
                                  consensus_z=jst._group_mean(js))

    def group_mean(s):
        return torch.einsum("stk,...tkj->...skj", ts.M, s)

    tr = tsw.stagewise_admm_solve(ts.sw, *td, iters=200,
                                  consensus_z=group_mean)
    for k, tol in (("obj", 1e-4), ("x", 1e-3), ("z", 1e-3), ("y", 1e-3)):
        want = np.asarray(getattr(jr, k), np.float64)
        err = np.max(np.abs(getattr(tr, k).numpy() - want)
                     / np.maximum(np.abs(want), 1.0))
        assert err <= tol, (k, err)
    tm = tsw.stagewise_admm_solve(ts.sw, *td, iters=200, consensus_M=ts.M)
    np.testing.assert_allclose(tr.x.numpy(), tm.x.numpy(), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="not both"):
        tsw.stagewise_admm_solve(ts.sw, *td, iters=2, consensus_M=ts.M,
                                 consensus_z=group_mean)


@pytest.mark.cuda
def test_mixed_schedule_and_precision_launch_their_kernels_on_the_card():
    """On the card the schedule is one split-phase launch plus K1 (N=12:
    the tensor-core kernel), "default" the one-pass kernel, and each is
    within the "mixed" limits of its plain version (objective 1e-4
    relative, x 0.1; the one-pass objective 1e-2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    rng = np.random.default_rng(2)
    c = JCondensed(jdi.switched_double_integrator(), 12,
                   jdi.default_weights())
    jq, js = c.device_qp(), jadmm.prepare_admm_mpc(c)
    x0s = rng.normal(size=(64, 2)).astype(np.float32)
    f, h = (np.stack([np.asarray(a) for a in fh]) for fh in
            zip(*[jq.assemble(jnp.asarray(x)) for x in x0s]))
    lb = np.broadcast_to(np.asarray(jq.lb), (64, jq.n)).copy()
    ub = np.broadcast_to(np.asarray(jq.ub), (64, jq.n)).copy()
    ts = convert.box_qp(js, "cuda")
    td = tuple(torch.as_tensor(a, device="cuda") for a in (f, h, lb, ub))
    kq = ca.kernel_qp_for(ts)
    for call, plain, want, tol in (
            (lambda: tadmm.admm_solve_mixed(ts, *td, iters=120),
             lambda: ca.admm_solve_plain(kq, *td, iters=120, low_frac=0.8),
             {"admm_k1_mixed": 1, "admm_k1": 1}, 1e-4),
            (lambda: ca.admm_solve_auto(dataclasses.replace(
                ts, precision="default", cache={}), *td, iters=120),
             lambda: ca.admm_solve_plain(kq, *td, iters=120, low_frac=1.0,
                                         lo_passes=1),
             {"admm_k1_mixed_1pass": 1, "admm_k1": 1}, 1e-2)):
        ca.reset_launch_counts()
        got = call()
        assert {k: v for k, v in ca.LAUNCHES.items() if v} == want
        ref = plain()
        rel = ((got.obj - ref.obj).abs() / ref.obj.abs().clamp_min(1.0))
        assert float(rel.max()) <= tol
        assert float((got.x - ref.x).abs().max()) <= 0.1
