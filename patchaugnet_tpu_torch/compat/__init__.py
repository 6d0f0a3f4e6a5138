"""Weights and optimizer state carried over from the JAX package."""
from .jax_params import load_jax_opt_state, load_jax_variables

__all__ = ["load_jax_variables", "load_jax_opt_state"]
