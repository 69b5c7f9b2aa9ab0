"""Hand-written GPU kernels.

A kernel lives here only where it beats what XLA compiles from the plain
jnp path on the card, at the shapes the benchmark uses; each keeps its
plain reference beside it. :mod:`tpuflow.kernels.hs_cuda` runs the
Horn-Schunck Jacobi sweeps in a temporally blocked CUDA kernel.
"""
