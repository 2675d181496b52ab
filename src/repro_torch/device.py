"""Device resolution and the port's numeric policy.

Every entry point runs on ``cuda`` unless the caller passes ``device="cpu"``
(the tests do). Asking for the default device without a GPU raises: nothing
falls back to the CPU behind the caller's back.

TF32 is off for matmuls and convolutions: a TF32 similarity keeps about
three decimal digits, which is enough to flip a theta_R accept/reject
decision, and the embedder runs in fp32.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def strict_fp32() -> None:
    """Turn TF32 off for matmuls and cuDNN and check that it stayed off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 \
            or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 could not be disabled")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain versions")
    strict_fp32()
    return dev
