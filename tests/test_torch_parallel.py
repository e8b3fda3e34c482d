"""The port's multi-device layer (parallel/) on the CPU: one world of 4 ranks
over gloo runs every case (tests/torch_parallel_ranks.py, a module that
never imports JAX), while this process computes the JAX package's readings
on conftest's 8 virtual devices.

Tolerances are the reference's (tests/test_parallel.py, tests/
test_bnb_search.py): the pool-sharded B&B at P=2 and P=4 finds what the
JAX package's sharded engine finds at the same P and what its single-device
engine finds at equal total capacity, objectives within rtol and atol
1e-3 (node and wave counts are printed, never compared: the search order
is the engine's own); two runs are bitwise equal, as is a one-rank mesh to
the unsharded loop; the ``rel_gap`` stop within 1e-4. The horizon axis:
``condense_horizon_sharded`` within rtol 1e-4, atol 1e-5 of
``condense_device``, the horizon-sharded sweep within 5e-4 of ``_solve_K``
(tests/test_stagewise.py)."""

import concurrent.futures

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from pyhybridcontrol_tpu.models.double_integrator import (
    default_weights as j_weights,
    switched_double_integrator as j_di,
)
from pyhybridcontrol_tpu.ops.admm import prepare_admm_mpc as j_prep
from pyhybridcontrol_tpu.ops.condense import CondensedMpc as JCondensed
from pyhybridcontrol_tpu.parallel import make_mesh as j_mesh
from pyhybridcontrol_tpu.parallel import solve_miqp_bnb_sharded as j_sharded
from pyhybridcontrol_tpu.solver.bnb import BnbSpec as JSpec
from pyhybridcontrol_tpu.solver.bnb import solve_miqp_bnb as j_solve
from pyhybridcontrol_tpu_torch.parallel import RankFailed, backend_for, spawn

WORLD_TIMEOUT = 240.0


def _jax_readings():
    c = JCondensed(j_di(), 6, j_weights())
    qp, admm = c.device_qp(), j_prep(c)
    f, h = qp.assemble(jnp.asarray(R.X0, jnp.float32))
    out = {"single": j_solve(admm, qp, f, h,
                             JSpec(capacity=256, wave_size=16,
                                   qp_iters=600))}
    for P in (2, 4):
        name = f"p{P}"
        out[name] = j_sharded(admm, qp, f, h, JSpec(**R.SPECS[name]),
                              j_mesh([("pool", P)]))
    ref = {k: (float(v.obj), bool(v.found), int(v.nodes_solved),
               int(v.waves)) for k, v in out.items()}
    ref["horizon"] = _jax_horizon()
    return ref


def _jax_horizon():
    """The horizon axis over 4 devices: the reference's
    ``condense_horizon_sharded`` at N=8 (Phi, Gv), and ``_solve_K_assoc``
    at N=64 with the horizon sharded (tests/test_stagewise.py), on the
    rank bodies' r."""
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as PS

    from pyhybridcontrol_tpu.ops.condense_scan import (
        condense_horizon_sharded as j_hz)
    from pyhybridcontrol_tpu.ops.stagewise import _solve_K_assoc
    from pyhybridcontrol_tpu.ops.stagewise import prepare_stagewise as j_sw

    mesh = j_mesh([("hz", 4)])
    phi, gv = j_hz(j_di(), R.HZ_N, mesh)
    sw = j_sw(j_di(), R.HZ_SWEEP_N, j_weights())
    r = jnp.asarray(np.random.default_rng(3).normal(
        size=(3, R.HZ_SWEEP_N, sw.b)), jnp.float32)
    fac = tuple(jax.device_put(f, NamedSharding(mesh, PS("hz", None, None)))
                for f in (sw.L, sw.Uinv, sw.C))
    x = jax.jit(lambda rr, ff: _solve_K_assoc(sw, rr, factors=ff))(
        jax.device_put(r, NamedSharding(mesh, PS(None, "hz", None))), fac)
    return dict(Phi=np.asarray(phi), Gv=np.asarray(gv), x=np.asarray(x))


@pytest.fixture(scope="module")
def world():
    """(every rank's results, the JAX readings): the world runs in a
    thread of its own while this process computes the readings."""
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(spawn, R.bnb_cases, 4, (), "cpu", WORLD_TIMEOUT)
        ref = _jax_readings()
        return ranks.result(), ref


def _same_on_ranks(res, case, ranks):
    """The case's result, held bitwise equal on every rank of its mesh."""
    first = res[0][case]
    for r in ranks[1:]:
        got = res[r][case]
        assert got["obj"] == first["obj"] and got["found"] == first["found"]
        np.testing.assert_array_equal(got["x"], first["x"])
        assert got["nodes"] == first["nodes"]
        assert got["waves"] == first["waves"]
    return first


@pytest.mark.parametrize("P", [2, 4])
def test_sharded_bnb_matches_the_reference(world, P):
    res, ref = world
    got = _same_on_ranks(res, f"p{P}", list(range(P)))
    j_obj, j_found, j_nodes, j_waves = ref[f"p{P}"]
    s_obj = ref["single"][0]
    print(f"P={P}: port {got['obj']:.6f} ({got['nodes']} nodes, "
          f"{got['waves']} waves); JAX sharded {j_obj:.6f} ({j_nodes} "
          f"nodes, {j_waves} waves); JAX single {s_obj:.6f}")
    assert got["found"] and j_found
    np.testing.assert_allclose(got["obj"], j_obj, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got["obj"], s_obj, rtol=1e-3, atol=1e-3)


def test_sharded_bnb_is_bitwise_repeatable(world):
    res, _ = world
    a, b = res[0]["repeat"]
    assert a["found"] and a["obj"] == b["obj"]
    np.testing.assert_array_equal(a["x"], b["x"])
    assert res[1]["repeat"][0]["obj"] == a["obj"]


def test_sharded_bnb_infeasible_state_is_found_on_no_rank(world):
    res, _ = world
    assert [res[r]["infeasible"]["found"] for r in (0, 1)] == [False, False]


def test_sharded_bnb_accepts_the_repair_seed(world):
    res, ref = world
    got = _same_on_ranks(res, "repair", [0, 1])
    assert got["seed_ok"] and got["found"]
    assert got["obj"] <= got["seed_obj"] + 1e-6
    np.testing.assert_allclose(got["obj"], ref["single"][0], rtol=1e-3,
                               atol=1e-3)


def test_rel_gap_stop_is_lock_step(world):
    """``rel_gap`` reads the reduced bound: every rank leaves on the same
    wave (a mismatch would hang the world until its timeout)."""
    res, ref = world
    got = _same_on_ranks(res, "rel_gap", [0, 1, 2, 3])
    assert got["found"]
    np.testing.assert_allclose(got["obj"], ref["single"][0], rtol=1e-4,
                               atol=1e-4)


def test_one_rank_mesh_is_the_unsharded_loop(world):
    res, _ = world
    sharded, plain = res[0]["p1"]
    for k in ("obj", "found", "nodes", "waves", "overflow", "bound"):
        assert sharded[k] == plain[k], k
    np.testing.assert_array_equal(sharded["x"], plain["x"])


def test_refusals(world):
    """A wave that P does not divide, a world smaller than the mesh, rows
    that do not split over the axis: ValueError on every rank."""
    res, _ = world
    for r in range(4):
        wave, small, rows = res[r]["refusals"]
        assert "wave_size must be divisible" in wave
        assert "need 8 ranks, have 4" in small
        assert "do not split evenly" in rows
    assert backend_for(4, "cpu") == "gloo"
    assert res[0]["backend"] == "gloo"
    if not torch.cuda.is_available():
        assert backend_for(1, "cuda") == "gloo"


def test_exchanged_children_take_free_slots_or_the_dump_row(world):
    """Every wave each rank scatters exactly the live children it received
    through the all_to_all into distinct free slots; the dead ones go to
    the dump row (``SCATTER_HOOK`` sees the exchanged scatter)."""
    res, _ = world
    total = 0
    for r in range(4):
        p4 = res[r]["p4"]
        assert len(p4["writes"]) == len(p4["live"]) == p4["waves"]
        for slots, live in zip(p4["writes"], p4["live"]):
            assert len(slots) == live and len(set(slots)) == live
            assert all(0 <= s < R.SPECS["p4"]["capacity"] for s in slots)
            total += live
    assert total > 0
    s = res[0]["p4"]["stats"]
    print(f"rank 0, P=4: {s['calls']} collectives, {s['bytes']} bytes, "
          f"{s['seconds'] * 1e3:.1f} ms")


def test_condense_horizon_sharded_rows(world):
    from pyhybridcontrol_tpu_torch.models.double_integrator import (
        switched_double_integrator)
    from pyhybridcontrol_tpu_torch.ops.condense_scan import condense_device

    res, ref = world
    full = condense_device(switched_double_integrator().to("cpu"), R.HZ_N)
    parts = sorted((res[r]["horizon"] for r in range(4)),
                   key=lambda h: h["rank"])
    for name in ("Phi", "Gv"):
        got = np.concatenate([p[name] for p in parts])
        for want in (ref["horizon"][name], full[name].numpy()):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
    assert "must divide" in parts[0]["refusal"]


def test_horizon_sharded_sweep_matches_solve_K(world):
    """The port's horizon-sharded sweep against the reference's
    ``_solve_K_assoc`` with the horizon sharded over 4 devices and against
    the port's sequential ``_solve_K``."""
    from pyhybridcontrol_tpu_torch.ops.stagewise import (
        _solve_K, prepare_stagewise)

    res, ref = world
    sw = prepare_stagewise(R.switched_double_integrator(), R.HZ_SWEEP_N,
                           R.default_weights(), device="cpu")
    r = torch.as_tensor(np.random.default_rng(3).normal(
        size=(3, R.HZ_SWEEP_N, sw.b)), dtype=torch.float32)
    parts = sorted((res[k]["horizon"] for k in range(4)),
                   key=lambda h: h["rank"])
    got = np.concatenate([p["x"] for p in parts], axis=1)
    for want in (ref["horizon"]["x"], _solve_K(sw, r).numpy()):
        np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)


def test_launcher_defaults_to_the_card(monkeypatch):
    """Without ``device_type`` the ranks are asked for the card: with none,
    ``spawn`` raises before it starts a rank."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        spawn(R.fails_on_rank_one, 2, timeout=60)


def test_launcher_reports_a_failed_rank():
    with pytest.raises(RankFailed, match="rank 1 gives up"):
        spawn(R.fails_on_rank_one, 2, (), "cpu", timeout=60)
