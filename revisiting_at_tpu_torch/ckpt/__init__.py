from .checkpoint import CheckpointManager, restore_run_weights
from .convert import (
    core_module,
    jax_params_to_state_dict,
    load_state_dict,
    load_torch_checkpoint,
    read_torch_checkpoint,
    save_torch_checkpoint,
    strip_prefixes,
)

__all__ = [
    "CheckpointManager",
    "core_module",
    "jax_params_to_state_dict",
    "load_state_dict",
    "load_torch_checkpoint",
    "read_torch_checkpoint",
    "restore_run_weights",
    "save_torch_checkpoint",
    "strip_prefixes",
]
