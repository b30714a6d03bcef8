"""The port's scheduler: the resource pool (resource.py), the network
topology (networktopology.py), the scheduling rounds with the round
dispatcher, native round driver and mirror (scheduling.py, mirror.py), the
SchedulerService (service.py), its YAML config (config.py), the brownout
ladder (degradation.py) and the process entry point (server.py); with the
evaluator (which a reference scheduler also loads through its plugin slot),
its metric families and rollout primitives, the model loader a scheduler
attaches a published artifact through, and the announcer that uploads its
telemetry to the trainer."""
