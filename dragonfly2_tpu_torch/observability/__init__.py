"""Observability of the port: the metric registry the trainer's families
live in, the span tracer its service runs under, and the feature sketch its
datasets freeze."""
