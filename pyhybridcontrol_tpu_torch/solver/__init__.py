from pyhybridcontrol_tpu_torch.solver.bnb import (
    BnbResult,
    BnbSpec,
    solve_miqp_bnb,
)
from pyhybridcontrol_tpu_torch.solver.bnb_stagewise import (
    StagewiseBackend,
    solve_miqp_bnb_stagewise,
)
from pyhybridcontrol_tpu_torch.solver.bnb_pooled import (
    KernelCondensedBackend,
    PooledState,
    solve_miqp_bnb_pooled,
)
from pyhybridcontrol_tpu_torch.solver.enumerate import (
    solve_miqp_enumerate_device,
)
from pyhybridcontrol_tpu_torch.solver.oracle import (
    OracleResult,
    solve_miqp_enumeration_oracle,
    solve_qp_oracle,
)

def __getattr__(name):
    # the consensus tree's B&B (ops/consensus_tree.py imports this package)
    if name == "solve_tree_miqp":
        from pyhybridcontrol_tpu_torch.ops.consensus_tree import (
            solve_tree_miqp)

        return solve_tree_miqp
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["BnbResult", "BnbSpec", "KernelCondensedBackend", "PooledState",
           "StagewiseBackend", "solve_miqp_bnb", "solve_miqp_bnb_pooled",
           "solve_miqp_bnb_stagewise",
           "solve_miqp_enumerate_device", "OracleResult",
           "solve_qp_oracle", "solve_miqp_enumeration_oracle",
           "solve_tree_miqp"]
