"""Observability of the port: the metric registry the trainer's and the
scheduler's families live in, the span tracer its services run under, the
feature sketch its datasets freeze, the drift detector serving compares
against it and the event-loop health monitor its scheduler runs."""
