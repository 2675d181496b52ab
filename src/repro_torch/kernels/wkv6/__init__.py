"""The RWKV6 (Finch) WKV recurrence (K5): hand-written Hopper kernel,
wrapper and plain version."""
