"""Weights carried over from the JAX package and from the reference's
PyTorch checkpoints."""
from .jax_params import load_jax_opt_state, load_jax_variables, to_jax_variables
from .torch_loader import load_torch_checkpoint, reference_state_dict, save_reference_checkpoint

__all__ = ["load_jax_variables", "load_jax_opt_state", "to_jax_variables", "load_torch_checkpoint",
           "reference_state_dict", "save_reference_checkpoint"]
