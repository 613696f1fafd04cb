"""Fault tolerance: failure injection and the restart runner."""
