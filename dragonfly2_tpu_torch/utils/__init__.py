"""Shared infrastructure of the port: the injectable clock, the service
entry points' signal wait, the token bucket, plugin loading by import path,
task/peer ids, piece geometry, the piece bitset, the thread-safe DAG, the
FSM, the gossip delta clock, the validated YAML config layer, the GC task
registry and per-component logging."""
