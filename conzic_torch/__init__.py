"""conzic_torch: the PyTorch / CUDA port of conzic_tpu, for one NVIDIA H100.

The JAX package ``conzic_tpu`` is the reference; this package mirrors its
layout (``models/``, ``ops/``, ``text/``, ``energies``, ``engine/``,
``config``) and imports nothing of it. Hand-written CUDA kernels live in
``csrc/`` with their wrappers and plain versions in ``kernels/``.
"""
