"""The scenario axis across ranks on the CPU: ``feedback_batch(mesh=)``, the
closed-loop batch on each rank's slice, and the consensus and stagewise
trees with ``scen_mesh``. One world of 4 ranks over gloo runs every case
(tests/torch_parallel_ranks.py, which never imports JAX): ranks 0-1 run
the two-rank meshes while ranks 2-3 compute the unsharded results, then
all four run the four-rank meshes. Meanwhile this process computes the
JAX package's readings of the same cases on the same inputs, sharded over
conftest's virtual devices (a mesh of 4 for the batches and the consensus
ADMM, of 2 for the trees' B&B and the stagewise ADMM: a sharding is a
layout, and the reference holds it to its unsharded run). Each case is
held against the JAX reading and against the port's unsharded run.

Tolerances are the reference's: ``feedback_batch`` within 1e-3 of the
unsharded call (tests/test_controller.py), ``found`` equal; the closed-loop
batch as tests/test_sharded_scenarios.py holds it (states rtol 1e-2, atol
5e-3; step-0 objectives 1e-3; all objectives rtol 2e-2, atol 1e-2); the
consensus tree's fixed-iteration ADMM as tests/test_torch_consensus_tree.py
holds ``tree_admm_solve`` (objective 1e-4 relative, x 1e-3, certificate
bits equal) and its B&B within 5e-3 (tests/test_consensus_tree.py); the
stagewise tree's ADMM as the consensus tree's, with either sweep
(``parallel_sweeps``), its B&B within 1e-3."""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as PS

import pyhybridcontrol_tpu.models.double_integrator as jdi
import torch_parallel_ranks as R
from pyhybridcontrol_tpu.control.mpc import MpcController as JController
from pyhybridcontrol_tpu.loop import closed_loop as j_closed_loop
from pyhybridcontrol_tpu.loop import make_mpc_step as j_mpc_step
from pyhybridcontrol_tpu.mld.info import MldInfo as JInfo
from pyhybridcontrol_tpu.mld.model import MldModel as JModel
from pyhybridcontrol_tpu.ops import consensus_tree as jct
from pyhybridcontrol_tpu.ops import stagewise_tree as jswt
from pyhybridcontrol_tpu.ops.admm import prepare_admm_mpc as j_prep
from pyhybridcontrol_tpu.ops.condense import CondensedMpc as JCondensed
from pyhybridcontrol_tpu.ops.scenario_tree import ScenarioTree as JTree
from pyhybridcontrol_tpu.parallel import make_mesh as j_mesh
from pyhybridcontrol_tpu.solver.bnb import BnbSpec as JSpec
from pyhybridcontrol_tpu_torch.parallel import spawn


def _j_omega_model():
    """The tree cases' model (R.omega_model) in the JAX package."""
    base = jdi.switched_double_integrator()
    m = base.numpy_mats()
    return JModel.from_matrices(
        JInfo(nx=2, nu=1, ndelta=1, nz=1, nomega=1, ny=2,
              ncons=base.info.ncons),
        A=m.A, B1=m.B1, B3=m.B3, B4=np.array([[0.0], [1.0]]), C=m.C,
        E=m.E, F1=m.F1, F2=m.F2, F3=m.F3, f5=m.f5)


def _j_batch(m4):
    """``feedback_batch(mesh=)`` (B&B and enumeration controllers) and the
    closed-loop batch, the batch sharded over the mesh's 4 devices."""
    model, w = jdi.switched_double_integrator(), jdi.default_weights()
    x0s = jnp.asarray(R.batch_states())
    out = {}
    for name, ctrl in (
            ("pooled", JController(model, 6, w,
                                   bnb_spec=JSpec(**R.FB_SPEC))),
            ("vmap", JController(model, 6, w, solver="enumerate",
                                 qp_iters=200))):
        r = ctrl.feedback_batch(x0s, mesh=m4)
        out[name] = dict(obj=np.asarray(r.obj), found=np.asarray(r.found),
                         u=np.asarray(r.u))
    c = JCondensed(model, 6, w)
    step = j_mpc_step(model, c.device_qp(), j_prep(c), method="bnb",
                      bnb_spec=JSpec(**R.FB_SPEC), shift_warm=False)
    run = jax.jit(jax.vmap(lambda x: j_closed_loop(model, step, x,
                                                   R.CL_T)))
    cl = run(jax.device_put(x0s, NamedSharding(m4, PS("scen"))))
    # the port's layout: xs (T+1, B, nx), objs (T, B)
    out["loop"] = dict(xs=np.asarray(cl.xs).swapaxes(0, 1),
                       objs=np.asarray(cl.objs).swapaxes(0, 1))
    return out


def _j_trees(m2, m4):
    """The consensus tree's ADMM (4 devices) and its B&B through the
    controller (2), the stagewise tree's ADMM and B&B (2)."""
    jm, w = _j_omega_model(), jdi.default_weights()
    paths = np.random.default_rng(3).normal(0.0, 0.3, size=(4, 6, 1))
    tree = JTree.from_branching(paths, branch_steps=(1, 3))
    x0 = jnp.asarray(R.TREE_X0, jnp.float32)
    tq = jct.prepare_tree_consensus(JCondensed(jm, tree.N, w), tree)
    f, h = jct.assemble_tree(tq, x0)
    lb = jnp.broadcast_to(tq.qp.lb, (tree.S, tq.nV))
    ub = jnp.broadcast_to(tq.qp.ub, (tree.S, tq.nV))
    a = jct.tree_admm_solve(tq, f, h, lb, ub, iters=R.TREE_ITERS,
                            scen_mesh=(m4, "scen"))
    out = {"tree_admm": dict(x=np.asarray(a.x), obj=float(a.obj),
                             r_prim=float(a.r_prim),
                             cert=bool(a.infeas_cert))}
    c = JController(jm, tree.N, w, bnb_spec=JSpec(**R.TREE_SPEC))
    c.set_scenario_tree(tree, consensus=True, scen_mesh=(m2, "scen"))
    r = c.feedback(np.asarray(R.TREE_X0, np.float32))
    out["ctrl"] = dict(obj=float(r.obj), found=bool(r.found))
    A_v = np.zeros((1, tree.N * 3))
    A_v[0, 0::3] = 1.0
    ts, tsp = (jswt.prepare_stagewise_tree(jm, tree, w, rho=rr,
                                           extra=(A_v, [2.0]))
               for rr in (1.0, 10.0))
    q, l, u = jswt.assemble_stagewise_tree(ts, x0)
    ue = jswt.assemble_stagewise_tree_ext(ts, x0)
    s = jswt.stagewise_tree_admm_solve(ts, q, l, u, iters=R.TREE_ITERS,
                                       ext_u=ue, scen_mesh=(m2, "scen"))
    out["sw_admm"] = dict(x=np.asarray(s.x), obj=float(s.obj),
                          y_ext=np.asarray(s.y_ext))
    s = jswt.stagewise_tree_admm_solve(ts, q, l, u, iters=R.TREE_ITERS,
                                       ext_u=ue, scen_mesh=(m2, "scen"),
                                       parallel_sweeps=True)
    out["sw_admm_par"] = dict(x=np.asarray(s.x), obj=float(s.obj),
                              y_ext=np.asarray(s.y_ext))
    b = jswt.solve_tree_miqp_stagewise(ts, q, l, u,
                                       JSpec(**R.SW_TREE_SPEC),
                                       swt_probe=tsp, ext_u=ue,
                                       scen_mesh=(m2, "scen"))
    out["sw_bnb"] = dict(obj=float(b.obj), found=bool(b.found))
    return out


def _jax_readings():
    m2, m4 = j_mesh([("scen", 2)]), j_mesh([("scen", 4)])
    return {"batch": _j_batch(m4), "trees": _j_trees(m2, m4)}


@pytest.fixture(scope="module")
def world():
    """(every rank's results, the JAX readings): the world runs in a
    thread of its own while this process computes the readings."""
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(spawn, R.scenario_cases, 4, (), "cpu", 240.0)
        ref = _jax_readings()
        return ranks.result(), ref


def _rel(a, b):
    return abs(float(a) - float(b)) / max(1.0, abs(float(b)))


def _batch(res, key, P):
    return res[0]["batch" if P == 2 else "batch4"][f"{key}{P}"]


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("engine", ["pooled", "vmap"])
def test_feedback_batch_mesh_matches_unsharded(world, engine, P):
    res, ref = world
    got = _batch(res, engine, P)
    for r in range(1, P):      # every rank returns the whole batch
        other = res[r]["batch" if P == 2 else "batch4"][f"{engine}{P}"]
        np.testing.assert_array_equal(other["obj"], got["obj"])
    assert got["obj"].shape == (R.FB_B,)
    for want in (ref["batch"][engine], res[2]["batch"][engine]):
        np.testing.assert_array_equal(got["found"], want["found"])
        np.testing.assert_allclose(got["obj"], want["obj"], rtol=1e-3,
                                   atol=1e-3)
        assert got["u"].shape == want["u"].shape


@pytest.mark.parametrize("P", [2, 4])
def test_sharded_closed_loop_batch(world, P):
    res, ref = world
    got = _batch(res, "loop", P)
    for want in (ref["batch"]["loop"], res[2]["batch"]["loop"]):
        np.testing.assert_allclose(got["xs"], want["xs"], rtol=1e-2,
                                   atol=5e-3)
        np.testing.assert_allclose(got["objs"][0], want["objs"][0],
                                   rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(got["objs"], want["objs"], rtol=2e-2,
                                   atol=1e-2)


@pytest.mark.parametrize("P", [2, 4])
def test_consensus_tree_admm_over_ranks(world, P):
    res, ref = world
    got = res[0][f"tree{P}"]["tree_admm"]
    for want in (ref["trees"]["tree_admm"], res[3]["tree1"]["tree_admm"]):
        assert _rel(got["obj"], want["obj"]) <= 1e-4
        np.testing.assert_allclose(got["x"], want["x"], rtol=1e-3,
                                   atol=1e-3)
        assert abs(got["r_prim"] - want["r_prim"]) <= 1e-2 * max(
            1.0, want["r_prim"])
        assert got["cert"] == want["cert"]
    assert res[P - 1][f"tree{P}"]["tree_admm"]["obj"] == got["obj"]


def test_consensus_tree_bnb_over_ranks(world):
    """The controller's consensus tree with ``scen_mesh`` over two ranks
    against the JAX package's over two devices and the port's
    unsharded."""
    res, ref = world
    got, want = res[0]["ctrl2"], res[2]["ctrl1"]
    j = ref["trees"]["ctrl"]
    assert got["found"] and want["found"] and j["found"]
    for obj in (j["obj"], want["obj"]):
        np.testing.assert_allclose(got["obj"], obj, rtol=5e-3, atol=5e-3)
    assert res[1]["ctrl2"]["obj"] == got["obj"]
    print(f"consensus tree: 2 ranks {got['obj']:.6f} ({got['nodes']} "
          f"nodes), unsharded {want['obj']:.6f} ({want['nodes']} nodes), "
          f"JAX on 2 devices {j['obj']:.6f}")


def test_stagewise_tree_admm_over_ranks(world):
    res, ref = world
    got = res[0]["tree2"]["sw_admm"]
    for want in (ref["trees"]["sw_admm"], res[3]["tree1"]["sw_admm"]):
        assert _rel(got["obj"], want["obj"]) <= 1e-4
        np.testing.assert_allclose(got["x"], want["x"], rtol=1e-3,
                                   atol=1e-3)
        np.testing.assert_allclose(got["y_ext"], want["y_ext"], rtol=1e-3,
                                   atol=1e-3)


def test_stagewise_tree_parallel_admm_over_ranks(world):
    """The stagewise tree's ADMM with ``parallel_sweeps=True`` and the
    scenario axis over two ranks (on the card the torch loop with K6's
    windowed sweep; here the reference's log-depth sweeps) against the JAX
    package's, sharded over two devices with ``parallel_sweeps=True``, and
    the port's unsharded parallel run; every rank returns the same."""
    res, ref = world
    got = res[0]["tree2"]["sw_admm_par"]
    for want in (ref["trees"]["sw_admm_par"], res[3]["tree1"]["sw_admm_par"]):
        assert _rel(got["obj"], want["obj"]) <= 1e-4
        np.testing.assert_allclose(got["x"], want["x"], rtol=1e-3,
                                   atol=1e-3)
        np.testing.assert_allclose(got["y_ext"], want["y_ext"], rtol=1e-3,
                                   atol=1e-3)
    assert res[1]["tree2"]["sw_admm_par"]["obj"] == got["obj"]


def test_stagewise_tree_bnb_over_ranks(world):
    res, ref = world
    got, want = res[0]["tree2"]["sw_bnb"], res[3]["tree1"]["sw_bnb"]
    j = ref["trees"]["sw_bnb"]
    assert got["found"] and want["found"] and j["found"]
    for obj in (j["obj"], want["obj"]):
        assert _rel(got["obj"], obj) <= 1e-3
    np.testing.assert_array_equal(res[1]["tree2"]["sw_bnb"]["x"], got["x"])
    s = res[0]["stats"]
    print(f"stagewise tree over 2 ranks: {got['obj']:.6f} ({got['nodes']} "
          f"nodes), unsharded {want['obj']:.6f}, JAX on 2 devices "
          f"{j['obj']:.6f}; rank 0's collectives: {s['calls']} calls, "
          f"{s['bytes']} bytes, {s['seconds']:.2f} s")
