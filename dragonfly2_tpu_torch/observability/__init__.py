"""Observability of the port: the metric registry the trainer's and the
evaluator's families live in, the span tracer its service runs under, the
feature sketch its datasets freeze and the drift detector serving compares
against it."""
