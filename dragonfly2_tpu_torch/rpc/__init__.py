"""The port's RPC: the framed-msgpack wire of the JAX package's rpc/core.py
with its client's retries and breaker, the trainer's adapters, the manager
client's trainer-side subset, and the scheduler's RPC server, wire client
and consistent-hash balancer."""
