"""cake-tpu on PyTorch and CUDA: the paged continuous-batching server,
the dense model with its sequential generator, and the command line
(`python -m cake_tpu_torch.cli`).

A port of `cake_tpu/` that keeps its module tree and names, so each
function here has a counterpart of the same name there. Plain tensor
math is PyTorch; the attention kernels the JAX package wrote in Pallas
(ragged paged attention, flash attention) are CUDA C++ written for
Hopper (`csrc/`), built with nvcc at first use into `_build/` and bound
with ctypes.

The package imports neither jax nor `cake_tpu`: host-only logic it
needs is copied here. Entry points take an explicit `device`, default
to "cuda", and raise when no card is present instead of falling back
to the CPU; tests pass device="cpu".
"""

__version__ = "0.1.0"
