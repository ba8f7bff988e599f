"""tpunode_torch: the PyTorch + CUDA port of tpunode's signature verification.

The JAX package ``tpunode`` is the reference; this package is its port to an
NVIDIA H100, slice by slice.  It imports torch, numpy and the standard
library only — never jax, never tpunode.  See README.md, "The PyTorch/CUDA
port".
"""
