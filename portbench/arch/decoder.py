"""The dense and DeepSeek-MoE decoder (a configuration without "arch"):
the port's `ArchConfig` from `program.py`, the weights' layout from
`weights.py`, the plain reference from `reference/model.py` and the model
FLOPs from `flops.py`."""
from portbench.flops import prefill_flops, train_step_flops  # noqa: F401
from portbench.program import arch as port_config  # noqa: F401
from portbench.reference.model import Reference  # noqa: F401
from portbench.weights import block_layout, segments  # noqa: F401
