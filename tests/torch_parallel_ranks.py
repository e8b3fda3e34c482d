"""Rank bodies of the port's multi-rank tests (tests/test_torch_parallel.py,
tests/test_torch_sharded_scenarios.py). The launcher pickles a rank body
by its qualified name and every rank imports this module, so it imports
torch and the port only, never JAX. Each body runs all of its module's
cases in one world of 4 ranks on the CPU (gloo) over sub-meshes of the
first 1, 2 or 4 ranks, and returns plain host values; a rank outside a
case's mesh returns None for it."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from pyhybridcontrol_tpu_torch.models.double_integrator import (
    default_weights,
    switched_double_integrator,
)
from pyhybridcontrol_tpu_torch.ops.admm import prepare_admm_mpc
from pyhybridcontrol_tpu_torch.ops.condense import CondensedMpc
from pyhybridcontrol_tpu_torch.parallel import (
    STATS,
    in_mesh,
    make_mesh,
    reset_stats,
    scenario_sharding,
)
from pyhybridcontrol_tpu_torch.parallel import sharded_bnb
from pyhybridcontrol_tpu_torch.parallel.sharded_bnb import (
    solve_miqp_bnb_sharded,
)
from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec, solve_miqp_bnb

# the cases of tests/test_parallel.py and tests/test_bnb_search.py, N=6
X0 = [2.0, 0.0]
X0_REPEAT = [-1.5, 1.0]
X0_INFEASIBLE = [50.0, 0.0]
SPECS = {
    "p4": dict(capacity=64, wave_size=16, qp_iters=600),
    "p2": dict(capacity=64, wave_size=8, qp_iters=400),
    "repeat": dict(capacity=64, wave_size=8, qp_iters=400),
    "infeasible": dict(capacity=32, wave_size=8, qp_iters=150),
    "repair": dict(capacity=64, wave_size=8, qp_iters=400),
    "rel_gap": dict(capacity=64, wave_size=8, max_waves=64, qp_iters=400,
                    rel_gap=1e-6, probe_patience=2),
    "p1": dict(capacity=64, wave_size=16, qp_iters=600),
}
HZ_N, HZ_SWEEP_N = 8, 64


def di_problem(N: int = 6):
    model = switched_double_integrator()
    c = CondensedMpc(model, N, default_weights())
    return model, c.device_qp("cpu"), prepare_admm_mpc(c, device="cpu")


def result(r) -> dict:
    return dict(obj=float(r.obj), x=r.x.numpy().copy(),
                found=bool(r.found), nodes=int(r.nodes_solved),
                waves=int(r.waves), overflow=bool(r.overflow),
                bound=float(r.best_open_bound))


def _dump_watch(log):
    """SCATTER_HOOK recorder: per child-1 scatter, the targets that are not
    the dump row."""
    def hook(name, idx, dump_row):
        if name == "bnb_child1":
            t = idx.tolist()
            log.append([i for i in t if i != dump_row])
    return hook


def refused(fn, *args, **kw):
    """The ValueError message of fn(*args, **kw), or None."""
    try:
        fn(*args, **kw)
    except ValueError as e:
        return str(e)
    return None


def bnb_cases():
    """Every pool-sharded B&B case, the mesh helpers, and the horizon
    axis."""
    from pyhybridcontrol_tpu_torch.solver import bnb_pooled

    model, qp, admm = di_problem()
    meshes = {P: make_mesh([("pool", P)], "cpu") for P in (1, 2, 4)}
    out = {"rank": dist.get_rank(),
           "backend": dist.get_backend()}

    def run(name, P, x0, seed=None, **kw):
        m = meshes[P]
        if not in_mesh(m):
            return None
        f, h = qp.assemble(torch.tensor(x0))
        spec = BnbSpec(**{**SPECS[name], **kw})
        return solve_miqp_bnb_sharded(admm, qp, f, h, spec, m,
                                      init_incumbent=seed)

    reset_stats()
    log, live = [], []
    bnb_pooled.SCATTER_HOOK = _dump_watch(log)
    orig = sharded_bnb.pool_hooks

    def counted(comm):
        hooks, root_here = orig(comm)
        ex = hooks.exchange_children

        def exchange(c1):
            got = ex(c1)
            live.append(int(got["live"].sum()))
            return got

        return dataclasses.replace(hooks, exchange_children=exchange), \
            root_here

    sharded_bnb.pool_hooks = counted
    try:
        r = run("p4", 4, X0)
    finally:
        bnb_pooled.SCATTER_HOOK = None
        sharded_bnb.pool_hooks = orig
    out["p4"] = dict(result(r), writes=log, live=live, stats=dict(STATS))
    r = run("p2", 2, X0)
    out["p2"] = None if r is None else result(r)
    a, b = run("repeat", 2, X0_REPEAT), run("repeat", 2, X0_REPEAT)
    out["repeat"] = None if a is None else (result(a), result(b))
    r = run("infeasible", 2, X0_INFEASIBLE)
    out["infeasible"] = None if r is None else result(r)
    if in_mesh(meshes[2]):
        from pyhybridcontrol_tpu_torch.solver.repair import (
            prepare_repair, root_repair_incumbent)

        x0 = torch.tensor(X0)
        f, h = qp.assemble(x0)
        rspec = prepare_repair(model, default_weights(), device="cpu")
        seed = root_repair_incumbent(admm, qp, rspec, x0, f, h,
                                     qp_iters=400)
        r = run("repair", 2, X0, seed=seed)
        out["repair"] = dict(result(r), seed_obj=float(seed[0]),
                             seed_ok=bool(seed[2]))
    r = run("rel_gap", 4, X0)
    out["rel_gap"] = result(r)
    if in_mesh(meshes[1]):
        r = run("p1", 1, X0)
        f, h = qp.assemble(torch.tensor(X0))
        u = solve_miqp_bnb(admm, qp, f, h, BnbSpec(**SPECS["p1"]))
        out["p1"] = (result(r), result(u))
    out["refusals"] = [refused(run, "p4", 4, X0, wave_size=6),
                       refused(make_mesh, [("pool", 8)], "cpu"),
                       refused(scenario_sharding(meshes[4], "pool").local,
                               torch.zeros(6, 2))]
    out["horizon"] = horizon_cases(model)
    return out


def horizon_cases(model):
    """``condense_horizon_sharded`` at N=8 and the horizon-sharded sweep
    at N=64 over 4 ranks (axis "hz"): this rank's rows, and its r."""
    from pyhybridcontrol_tpu_torch.ops.condense_scan import (
        condense_horizon_sharded)
    from pyhybridcontrol_tpu_torch.ops.stagewise import (
        prepare_stagewise, solve_K_horizon_sharded)

    mesh = make_mesh([("hz", 4)], "cpu")
    d = mesh.get_local_rank("hz")
    phi, gv = condense_horizon_sharded(model.to("cpu"), HZ_N, mesh)
    sw = prepare_stagewise(model, HZ_SWEEP_N, default_weights(),
                           device="cpu")
    r = torch.as_tensor(np.random.default_rng(3).normal(
        size=(3, HZ_SWEEP_N, sw.b)), dtype=torch.float32)
    Nl = HZ_SWEEP_N // 4
    x = solve_K_horizon_sharded(sw, r[:, d * Nl:(d + 1) * Nl], mesh)
    return dict(rank=d, Phi=phi.numpy(), Gv=gv.numpy(), x=x.numpy(),
                refusal=refused(condense_horizon_sharded, model, 6, mesh))


def condense_rows(N: int):
    """This rank's rows of ``condense_horizon_sharded`` over the whole
    world (axis "hz")."""
    from pyhybridcontrol_tpu_torch.ops.condense_scan import (
        condense_horizon_sharded)

    mesh = make_mesh([("hz", dist.get_world_size())], "cpu")
    phi, gv = condense_horizon_sharded(switched_double_integrator(), N, mesh)
    return phi.numpy(), gv.numpy()


def fails_on_rank_one():
    """A rank body whose rank 1 raises (the launcher must report it)."""
    if dist.get_rank() == 1:
        raise ValueError("rank 1 gives up")
    dist.barrier()


# ---- scenario axis (tests/test_torch_sharded_scenarios.py) ------------------

# the pooled engine's node budget is global, not per instance: the closed
# loop's twin holds where it does not bind (64 waves; the reference's 24
# are per instance)
FB_SPEC = dict(capacity=64, wave_size=8, qp_iters=200, max_waves=64)
FB_B, CL_T = 16, 4
TREE_SPEC = dict(capacity=64, wave_size=8, max_waves=6, qp_iters=150,
                 probe_iters=300, probe_patience=2)
SW_TREE_SPEC = dict(capacity=64, wave_size=8, max_waves=6, qp_iters=100,
                    probe_iters=300)
TREE_X0 = [2.0, 0.0]
TREE_ITERS = 120


def omega_model():
    """The double integrator with a velocity disturbance (the tree tests'
    model), built from the port's own matrices."""
    from pyhybridcontrol_tpu_torch.mld.info import MldInfo
    from pyhybridcontrol_tpu_torch.mld.model import MldModel

    base = switched_double_integrator()
    m = base.numpy_mats()
    return MldModel.from_matrices(
        MldInfo(nx=2, nu=1, ndelta=1, nz=1, nomega=1, ny=2,
                ncons=base.info.ncons),
        A=m.A, B1=m.B1, B3=m.B3, B4=np.array([[0.0], [1.0]]), C=m.C,
        E=m.E, F1=m.F1, F2=m.F2, F3=m.F3, f5=m.f5)


def fixture_tree(S=4, N=6, steps=(1, 3), seed=3):
    from pyhybridcontrol_tpu_torch.ops.scenario_tree import ScenarioTree

    paths = np.random.default_rng(seed).normal(0.0, 0.3, size=(S, N, 1))
    return ScenarioTree.from_branching(paths, branch_steps=steps)


def batch_states():
    return np.random.default_rng(12).normal(size=(FB_B, 2)).astype(
        np.float32)


def host(d):
    return {k: v.numpy().copy() for k, v in d.items()}


def batch_cases(meshes, unsharded: bool):
    """``feedback_batch(mesh=)`` (the pooled engine and the vmap engine
    of an enumeration controller) and the closed-loop batch on each rank's
    slice, gathered; ``unsharded``: the same on one rank, whole."""
    from pyhybridcontrol_tpu_torch.control.mpc import MpcController
    from pyhybridcontrol_tpu_torch.loop.closed_loop import (
        closed_loop_batch, make_mpc_step_batch)
    from pyhybridcontrol_tpu_torch.parallel import scenario_sharding

    model = switched_double_integrator()
    x0s = batch_states()
    bnb = MpcController(model, 6, default_weights(),
                        bnb_spec=BnbSpec(**FB_SPEC), device="cpu")
    en = MpcController(model, 6, default_weights(), solver="enumerate",
                       qp_iters=200, device="cpu")
    step = make_mpc_step_batch(model, bnb.device_qp, bnb.admm,
                               bnb_spec=BnbSpec(**FB_SPEC),
                               shift_warm=False)
    out = {}
    for P, m in meshes.items():
        if m is None or not in_mesh(m):
            continue
        out[f"pooled{P}"] = host(bnb.feedback_batch(x0s, mesh=m))
        out[f"vmap{P}"] = host(en.feedback_batch(x0s, mesh=m,
                                                 engine="vmap"))
        sh = scenario_sharding(m, "scen")
        cl = closed_loop_batch(model, step, sh.local(torch.as_tensor(x0s)),
                               CL_T)
        out[f"loop{P}"] = dict(xs=sh.gather(cl.xs, dim=1).numpy(),
                               objs=sh.gather(cl.objs, dim=1).numpy())
    if unsharded:
        out["pooled"] = host(bnb.feedback_batch(x0s))
        out["vmap"] = host(en.feedback_batch(x0s, engine="vmap"))
        cl = closed_loop_batch(model, step, torch.as_tensor(x0s), CL_T)
        out["loop"] = dict(xs=cl.xs.numpy(), objs=cl.objs.numpy())
    return out


def tree_cases(mesh, stagewise: bool = True):
    """Over ``mesh`` ((mesh, "scen")), or whole where mesh is None: the
    consensus tree's fixed-iteration ADMM and, with ``stagewise``, the
    stagewise tree's (with a budget row; also with ``parallel_sweeps``)
    and its B&B."""
    from pyhybridcontrol_tpu_torch.ops import consensus_tree as tct
    from pyhybridcontrol_tpu_torch.ops import stagewise_tree as tst

    sm = None if mesh is None else (mesh, "scen")
    model, tree = omega_model(), fixture_tree()
    x0 = torch.tensor(TREE_X0)
    tq = tct.prepare_tree_consensus(CondensedMpc(model, tree.N,
                                                 default_weights()),
                                    tree, device="cpu")
    f, h = tct.assemble_tree(tq, x0)
    lb, ub = tq.qp.lb.expand(tq.S, -1), tq.qp.ub.expand(tq.S, -1)
    a = tct.tree_admm_solve(tq, f, h, lb, ub, iters=TREE_ITERS,
                            scen_mesh=sm)
    out = {"tree_admm": dict(x=a.x.numpy(), obj=float(a.obj),
                             r_prim=float(a.r_prim), r_dual=float(a.r_dual),
                             cert=bool(a.infeas_cert))}
    if not stagewise:
        return out
    A_v = np.zeros((1, tree.N * 3))
    A_v[0, 0::3] = 1.0
    ts, tsp = (tst.prepare_stagewise_tree(model, tree, default_weights(),
                                          rho=rr, extra=(A_v, [2.0]),
                                          device="cpu")
               for rr in (1.0, 10.0))
    q, l, u = tst.assemble_stagewise_tree(ts, x0)
    ue = tst.assemble_stagewise_tree_ext(ts, x0)
    s = tst.stagewise_tree_admm_solve(ts, q, l, u, iters=TREE_ITERS,
                                      ext_u=ue, scen_mesh=sm)
    out["sw_admm"] = dict(x=s.x.numpy(), obj=float(s.obj),
                          r_prim=float(s.r_prim), y_ext=s.y_ext.numpy())
    s = tst.stagewise_tree_admm_solve(ts, q, l, u, iters=TREE_ITERS,
                                      ext_u=ue, scen_mesh=sm,
                                      parallel_sweeps=True)
    out["sw_admm_par"] = dict(x=s.x.numpy(), obj=float(s.obj),
                              y_ext=s.y_ext.numpy())
    r = tst.solve_tree_miqp_stagewise(ts, q, l, u, BnbSpec(**SW_TREE_SPEC),
                                      swt_probe=tsp, ext_u=ue, scen_mesh=sm)
    out["sw_bnb"] = result(r)
    return out


def controller_cases(mesh):
    """The controller's consensus tree with ``scen_mesh`` (its B&B,
    ``solve_tree_miqp``, through ``feedback``)."""
    from pyhybridcontrol_tpu_torch.control.mpc import MpcController

    model, tree = omega_model(), fixture_tree()
    c = MpcController(model, tree.N, default_weights(),
                      bnb_spec=BnbSpec(**TREE_SPEC), device="cpu")
    c.set_scenario_tree(tree, consensus=True,
                        scen_mesh=None if mesh is None else (mesh, "scen"))
    r = c.feedback(np.asarray(TREE_X0, np.float32))
    return dict(obj=float(r.obj), u=r.u.numpy(), found=bool(r.found),
                nodes=int(r.nodes))


def scenario_cases():
    """Every scenario-axis case. Ranks 0-1 run the two-rank meshes while
    ranks 2-3 compute the unsharded results; then all four run the
    four-rank meshes."""
    m2 = make_mesh([("scen", 2)], "cpu")
    m4 = make_mesh([("scen", 4)], "cpu")
    rank = dist.get_rank()
    reset_stats()
    out = {"rank": rank}
    if rank < 2:
        out["batch"] = batch_cases({2: m2}, unsharded=False)
        out["tree2"] = tree_cases(m2)
        out["ctrl2"] = controller_cases(m2)
    elif rank == 2:
        out["batch"] = batch_cases({}, unsharded=True)
        out["ctrl1"] = controller_cases(None)
    else:
        out["tree1"] = tree_cases(None)
    out["batch4"] = batch_cases({4: m4}, unsharded=False)
    out["tree4"] = tree_cases(m4, stagewise=False)
    out["stats"] = dict(STATS)
    return out
