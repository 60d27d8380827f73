"""Checkpoints: the JAX-variables weight bridge (`from_jax`) and the training
checkpoint manager (`manager`)."""
from .manager import CheckpointManager  # noqa: F401
