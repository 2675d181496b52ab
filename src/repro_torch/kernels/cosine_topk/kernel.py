"""Build and bind the hand-written Hopper cosine top-k kernels (K1, K2).

The build machinery is shared by every kernel of the port
(``repro_torch.kernels._build``): one ``nvcc`` per source for ``sm_90a``,
a plain C entry point loaded with ``ctypes``, libraries named by source
hash under ``build/kernels``. Nothing here runs at import time.
"""
from __future__ import annotations

from repro_torch.kernels import _build
from repro_torch.kernels._build import BUILD_DIR, CSRC, NVCC_FLAGS, load  # noqa: F401

NAMES = ("cosine_topk", "cosine_topk_q8")
KERNELS = {n: _build.KERNELS[n] for n in NAMES}


def build(names=NAMES) -> dict[str, str]:
    """Build K1 and K2 (or ``names``) where no library exists yet, in
    parallel; returns {name: ptxas report} for the ones built now."""
    return _build.build(names)
