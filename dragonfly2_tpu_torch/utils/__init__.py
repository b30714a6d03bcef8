"""Shared infrastructure of the port: the injectable clock, the service
entry points' signal wait, the token bucket and plugin loading by import
path."""
