"""Multi-tenant namespaces (port of ``repro/core/tenancy.py``, DESIGN.md
§14): configuration only.

Overlays, the tenant registry and fair-share eviction come with ROADMAP
Queue A item 3 (persistence, tiers, tenants). Until then this module holds
what ``serving/config.py`` nests: :class:`TenancyConfig`, carried over
field for field. Setting ``ServingConfig.tenancy`` raises
``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass

@dataclass
class TenancyConfig:
    overlay_capacity: int = 64   # per-tenant overlay rows; 0 disables
                                 # overlays (shared-cache-only tenancy)
    personal_sim: float = 0.90   # an engine answer whose query is this
                                 # similar to the tenant's recent misses is
                                 # classified personal -> overlay admission
    recent_window: int = 32      # recent-miss vectors kept per tenant for
                                 # the personal/global classification
    fair_share_eviction: bool = True
                                 # tenant-weighted victim selection in
                                 # spill insert/trim, refresh filter
                                 # eviction, and tier demotion
    per_tenant_theta: bool = True
                                 # per-namespace DynamicThreshold state
    max_tenants: int = 4096      # hard cap on tracked namespaces
    registry_cap: int = 1 << 16  # answer-id -> tenant map entries (FIFO)
