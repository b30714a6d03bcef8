"""Shared infrastructure of the port: the injectable clock."""
