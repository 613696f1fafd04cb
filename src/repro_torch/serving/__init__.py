"""Serving control plane and the real-model executor."""
