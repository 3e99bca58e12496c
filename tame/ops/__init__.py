"""Vectorized core ops: dyadic contractions, batched small-SPD linear
algebra and block-tridiagonal smoothers, all in plain ``jax.numpy``."""

from tame.ops import dyad

__all__ = ["dyad"]
