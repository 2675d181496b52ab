"""SISO core, ported: centroid store, clustering, semantic cache,
Algorithm-1 cache manager, refresh pipeline, dynamic threshold and the
SISO facade. Submodules are imported by the caller; this package imports
none of them eagerly."""
