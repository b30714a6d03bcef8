"""Resilience of the port: the seeded fault injection (``faultline``) behind
named points on the port's artifact loads and RPC wire."""
