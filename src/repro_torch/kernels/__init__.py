"""Hand-written Hopper kernels. Each kernel package keeps the reference's
three files: ``kernel.py`` (build + launch of the CUDA source in
``repro_torch/csrc``), ``ops.py`` (the wrapper: kernel for CUDA tensors,
plain version for CPU tensors) and ``ref.py`` (the plain PyTorch version)."""
