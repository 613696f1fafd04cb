"""PyTorch/CUDA port of the ``repro`` package: multi-LoRA serving with
compressed adapters, on an NVIDIA H100.

It keeps ``repro``'s layout and names (``configs``, ``models``,
``kernels``, ``serving``, ``launch``) and imports nothing of it: what it
needs from the JAX package it keeps in its own copy.  Entry points run on
the CUDA card unless the caller passes ``device="cpu"``.
"""
