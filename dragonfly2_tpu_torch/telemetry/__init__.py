"""Training-telemetry records of the port: the download and
network-topology row schemas the scheduler streams to the trainer, the
rotating columnar stores that hold them on the scheduler's side, and the
per-edge bandwidth history the scheduler's feature build reads."""

from dragonfly2_tpu_torch.telemetry.bandwidth import (  # noqa: F401
    BANDWIDTH_NORM_BPS,
    BandwidthHistory,
)
from dragonfly2_tpu_torch.telemetry.records import (  # noqa: F401
    DOWNLOAD_DTYPE,
    PROBE_DTYPE,
    ColumnarStore,
    TelemetryStorage,
)
