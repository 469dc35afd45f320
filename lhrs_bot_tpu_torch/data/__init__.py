"""Data: the training collators (jax-free copies of the JAX package's)."""

from .collate import PackingCollator, SupervisedCollator  # noqa: F401
