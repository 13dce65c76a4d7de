"""Utilities: weights carried over from the JAX package."""
