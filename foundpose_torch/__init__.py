"""PyTorch + CUDA port of foundpose_tpu.

The package mirrors the JAX package's module paths (structs, geometry, ops/,
models/, pose/, pipeline/, eval/, data/) so each module's counterpart is
easy to find.
Where the JAX package runs a Pallas TPU kernel, this package runs a CUDA
kernel written by hand for Hopper (sources under `csrc/`, built at first use
by `_kernels.py`), with a plain PyTorch twin of the same function beside it
that CPU tensors use. Nothing here imports JAX.
"""
