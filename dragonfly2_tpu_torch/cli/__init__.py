"""Command-line tools of the port: ``dfstress``, the load generator for a
daemon's download RPC and for the scoring serving path."""
