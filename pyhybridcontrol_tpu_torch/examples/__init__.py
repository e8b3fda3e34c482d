"""Runnable studies, the port's counterparts of ``examples/*.py``:
``python -m pyhybridcontrol_tpu_torch.examples.<name> [--device cpu]``."""
