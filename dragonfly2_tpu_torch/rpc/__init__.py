"""The port's RPC: the framed-msgpack wire of the JAX package's rpc/core.py,
the trainer's adapters and the manager client's trainer-side subset."""
