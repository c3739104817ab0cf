"""Kernels of the port: hand-written CUDA for Hopper with plain PyTorch
versions beside them (``ref.py``).  Importing this package builds nothing;
the CUDA library is compiled at the first launch (``_build.load``)."""
