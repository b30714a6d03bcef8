"""The scheduler's side of the port: the model loader a scheduler attaches
a published artifact through, and the announcer that uploads its telemetry
to the trainer."""
