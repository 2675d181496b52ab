"""Serving layer, ported: engines (the real-model ``ModelEngine`` and the
analytic ``AnalyticEngine``), continuous batching, the gateway, the
baselines, the SLO simulator, the scenario-diverse workload generators,
the composable ``ServingConfig`` and the CacheFrontend protocol."""
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.serving.config import (CacheConfig, PersistenceConfig,
                                        RefreshConfig, ReplicationConfig,
                                        ServingConfig)
from repro_torch.serving.gateway import (GatewayRequest, GatewayStats,
                                         ServingGateway)
from repro_torch.serving.workloads import SCENARIOS, Scenario, build_scenario


@runtime_checkable
class CacheFrontend(Protocol):
    """The frontend contract the gateway/simulator drive (DESIGN.md §7).
    Every frontend (``NoCache``, ``VectorCache``, SemanticCache-backed
    ``SISO``) implements:

    * ``lookup(vectors, ...) -> LookupResult``-like (hit/sim/answer/
      answer_id/entry/region); richer frontends may take ``now``/
      ``user_ids`` kwargs, and SISO's ``handle_batch`` is feature-detected
      first by the gateway.
    * ``record(vector, answer, answer_id=...)``: fold one LLM completion
      back into the cache.
    * ``stats() -> dict``: at least ``hit_ratio``.
    * ``state_dict() -> dict``: snapshotable state (arrays/scalars);
      stateless frontends return ``{}``.

    ``runtime_checkable`` verifies member presence only; the conformance
    test (tests/test_torch_serving_config.py) exercises actual call/return
    shapes.
    """

    def lookup(self, vectors: np.ndarray, **kwargs): ...

    def record(self, vector: np.ndarray, answer: np.ndarray,
               **kwargs) -> None: ...

    def stats(self) -> dict: ...

    def state_dict(self) -> dict: ...


__all__ = ["CacheFrontend", "CacheConfig", "GatewayRequest", "GatewayStats",
           "PersistenceConfig", "RefreshConfig", "ReplicationConfig",
           "ServingConfig", "ServingGateway", "SCENARIOS", "Scenario",
           "build_scenario"]
