"""Crash-safe checkpointing, ported (``checkpoint/manager.py``)."""
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
