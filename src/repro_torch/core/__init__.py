"""The compression core: joint diagonalization, clustering and the serving
export of LoRA collections (the port of the JAX package's ``core``)."""
