"""Command-line tools of the port: ``dfget`` and ``dfcache``, the thin
clients of a daemon's download and cache RPCs; ``dfstress``, the load generator for a
daemon's download RPC, for the scoring serving path and (``--swarm``) for a
federation of schedulers' control plane; ``dfsim``, the swarm simulator over
the port's control plane; and the ML plane's operator tools ``dftop`` (the
manager's cluster view), ``dfml`` (decision replay, training history) and
``dfmodel`` (checkpoint publish and fetch through the daemon, and the
rollout commands)."""
