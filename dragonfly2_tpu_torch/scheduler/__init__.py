"""The scheduler's side of the port: the model loader a scheduler attaches
a published artifact through, the announcer that uploads its telemetry to
the trainer, and the evaluator (with its metric families and rollout
primitives) a reference scheduler loads through its plugin slot."""
