"""PyTorch / CUDA port of the `repro` LM substrate.

The JAX package `repro` is the reference and stays as it is.  This package
imports neither JAX nor anything of `repro`: it keeps its own copies of the
configs, and every Pallas kernel on its path is a kernel written by hand for
Hopper (sm_90a) under `kernels/csrc/`.  Entry points run on `cuda` unless the
caller passes `device="cpu"`.
"""
