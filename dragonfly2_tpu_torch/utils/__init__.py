"""Shared infrastructure of the port: the injectable clock and the
service entry points' signal wait."""
