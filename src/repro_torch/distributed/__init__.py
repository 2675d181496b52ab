"""Distributed planes, ported: the sharded cache plane, replication and
its transport. Each module holds its configuration until the ROADMAP
Queue A item that brings its plane."""
