"""PyTorch/CUDA port of the KV-RM serving engine.

The JAX package ``repro`` is the reference; this package mirrors its module
names (``configs``, ``core``, ``kernels``, ``models``, ``data``,
``serving``, ``launch``) so every module has a counterpart there. It imports
``torch``, numpy and the standard library only. The paged decode and
chunked prefill attention kernels are CUDA C++ for Hopper
(``kernels/csrc``), built with ``nvcc`` at first use.
"""
