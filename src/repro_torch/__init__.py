"""PyTorch/CUDA port of the SISO serving stack (``src/repro`` is the JAX
reference).

The package mirrors the reference layout (``core/``, ``kernels/``,
``models/``, ``serving/``, ``configs/``, ``data/``). Importing it is light:
no submodule, no CUDA library and no compiler is touched until a caller
asks for one. Every entry point takes a ``device`` argument that defaults
to ``cuda`` (see :mod:`repro_torch.device`).
"""
