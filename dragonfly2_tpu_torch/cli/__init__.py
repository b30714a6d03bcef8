"""Command-line tools of the port: ``dfstress``, the load generator for a
daemon's download RPC, for the scoring serving path and (``--swarm``) for a
federation of schedulers' control plane."""
