"""cales_torch: the PyTorch + CUDA port of cales_tpu for NVIDIA GPUs: one
card, or a y-slab mesh of ranks on torch.distributed (parallel/).

Imports torch and never jax, and nothing of cales_tpu.  It keeps its own
copies of the JAX package's numpy-only modules (config, nml, grid,
initflow and io), under the same names, so each counterpart is easy to
find; the tests hold the copies to the originals.
"""
