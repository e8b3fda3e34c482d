from pyhybridcontrol_tpu_torch.ops.admm import (
    AdmmResult,
    BoxQP,
    admm_solve,
    admm_solve_batch,
    admm_solve_mixed,
    prepare_admm,
    prepare_admm_mpc,
)
from pyhybridcontrol_tpu_torch.ops.condense import (
    CondensedMpc,
    DeviceQP,
    MpcWeights,
)
from pyhybridcontrol_tpu_torch.ops.cuda_admm import (
    admm_solve_auto,
    admm_wave_auto,
    prepare_kernel_qp,
)
from pyhybridcontrol_tpu_torch.ops.presolve import tighten_condensed
from pyhybridcontrol_tpu_torch.ops.scenario_tree import (
    ScenarioTree,
    build_scenario_tree_qp,
    tree_branch_map,
    tree_consistent_paths,
    tree_price_seq,
)

# ops/consensus_tree.py runs the B&B loop of solver/bnb.py, which imports
# this package: its names load on first use
_CONSENSUS = ("TreeBackend", "TreeConsensusQP", "assemble_tree",
              "prepare_tree_consensus", "solve_tree_miqp", "tree_admm_solve")


def __getattr__(name):
    if name in _CONSENSUS:
        from pyhybridcontrol_tpu_torch.ops import consensus_tree

        return getattr(consensus_tree, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AdmmResult", "BoxQP", "admm_solve", "admm_solve_batch",
    "admm_solve_mixed", "prepare_admm", "prepare_admm_mpc",
    "CondensedMpc", "DeviceQP", "MpcWeights",
    "admm_solve_auto", "admm_wave_auto", "prepare_kernel_qp",
    "tighten_condensed",
    "ScenarioTree", "build_scenario_tree_qp", "tree_branch_map",
    "tree_consistent_paths", "tree_price_seq",
    *_CONSENSUS,
]
