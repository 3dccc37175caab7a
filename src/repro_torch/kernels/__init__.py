"""Hand-written Hopper kernels of the port, one ``kernels/<name>/`` triple
each: ``ref.py`` (the plain PyTorch version), ``kernel.py`` (the wrapper
of the CUDA kernel in ``src/repro_torch/csrc/<name>.cu``) and ``ops.py``
(dispatch on the tensor's device: plain on the CPU, the kernel on CUDA)."""
