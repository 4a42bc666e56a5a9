"""cales_torch: the PyTorch + CUDA port of cales_tpu for one NVIDIA GPU.

Imports torch and never jax.  The numpy-only modules of cales_tpu (config,
nml, grid, initflow, io) are reused as they are; the modules here keep the
JAX package's names so each counterpart is easy to find.
"""
