"""Training-telemetry records of the port: the download and
network-topology row schemas the scheduler streams to the trainer, and the
rotating columnar stores that hold them on the scheduler's side."""

from dragonfly2_tpu_torch.telemetry.records import (  # noqa: F401
    DOWNLOAD_DTYPE,
    PROBE_DTYPE,
    ColumnarStore,
    TelemetryStorage,
)
