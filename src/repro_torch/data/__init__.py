"""Synthetic tasks and the deterministic data pipeline (copies of the JAX
package's numpy-only ``data/``)."""
