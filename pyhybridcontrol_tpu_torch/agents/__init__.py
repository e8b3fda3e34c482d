from pyhybridcontrol_tpu_torch.agents.agent import (
    Agent,
    ControlledAgent,
    MpcAgent,
)

__all__ = ["Agent", "ControlledAgent", "MpcAgent"]
