"""Training-telemetry record schemas of the port: the download and
network-topology rows the scheduler streams to the trainer."""

from dragonfly2_tpu_torch.telemetry.records import DOWNLOAD_DTYPE, PROBE_DTYPE  # noqa: F401
