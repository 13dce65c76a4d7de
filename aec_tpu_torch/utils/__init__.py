"""Utilities: weights carried over from and back to the JAX package,
logging and accounting helpers."""
