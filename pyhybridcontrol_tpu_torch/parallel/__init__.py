"""The multi-device layer on ``torch.distributed``: meshes, the launcher
and the pool-sharded B&B (counterpart of ``pyhybridcontrol_tpu/parallel``).
The scenario- and horizon-sharded paths take a mesh where the reference
does: ``MpcController.feedback_batch(mesh=)``, ``set_scenario_tree(
scen_mesh=)``, ``ops.condense_scan.condense_horizon_sharded`` and
``ops.stagewise.solve_K_horizon_sharded``."""

from pyhybridcontrol_tpu_torch.parallel.mesh import (
    STATS,
    AxisComm,
    ScenarioSharding,
    backend_for,
    gather_rows,
    in_mesh,
    make_mesh,
    replicated,
    reset_stats,
    scenario_sharding,
)
from pyhybridcontrol_tpu_torch.parallel.launch import RankFailed, spawn


def __getattr__(name):
    # solver/bnb.py imports the ops, which import this package lazily
    if name == "solve_miqp_bnb_sharded":
        from pyhybridcontrol_tpu_torch.parallel.sharded_bnb import (
            solve_miqp_bnb_sharded)

        return solve_miqp_bnb_sharded
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["STATS", "AxisComm", "RankFailed", "ScenarioSharding",
           "backend_for", "gather_rows", "in_mesh", "make_mesh",
           "replicated", "reset_stats", "scenario_sharding", "spawn",
           "solve_miqp_bnb_sharded"]
