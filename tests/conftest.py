import os

# Tests run on the single host device — the 512-device override belongs to
# launch/dryrun.py ONLY (smoke tests must see 1 device).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def normalize(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)


@pytest.fixture
def unit_vectors(rng):
    def make(n: int, d: int = 32) -> np.ndarray:
        return normalize(rng.normal(size=(n, d)).astype(np.float32))
    return make


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips with a reason without one)")
