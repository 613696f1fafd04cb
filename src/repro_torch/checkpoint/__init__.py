"""Checkpoints on disk in the JAX package's layout."""
