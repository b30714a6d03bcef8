"""Trainer metric families + the per-step training-run telemetry hook.

The port's own copy of dragonfly2_tpu/trainer/metrics.py, registered in the
port's metric registry. The ``dragonfly_train_*`` families put per-step
learner signals on the trainer's metrics plane: steps and examples consumed,
the latest loss and pre-clip gradient norm, runs by outcome and the last
run's final loss.

TrainRunTelemetry is the hook object the trainers call: train_mlp.train and
train_gnn.train_async accept ``telemetry=`` and report host-visible steps as
they complete. It also keeps a BOUNDED per-run loss curve (stride-halving
downsample, ≤ _CURVE_CAP points) for the run manifest ``train_history``
serves.
"""

from __future__ import annotations

import math
import threading

from dragonfly2_tpu_torch.observability.metrics import default_registry
from dragonfly2_tpu_torch.utils.clock import SYSTEM, Clock

_r = default_registry()

TRAIN_STEPS_TOTAL = _r.counter(
    "steps_total",
    "Optimizer steps completed, per model type (rate = steps/s)",
    subsystem="train", labels=("model",),
)
TRAIN_EXAMPLES_TOTAL = _r.counter(
    "examples_total",
    "Training examples consumed (steps x batch size), per model type",
    subsystem="train", labels=("model",),
)
TRAIN_LOSS = _r.gauge(
    "loss",
    "Most recent training-step loss, per model type (curves ride /debug/ts)",
    subsystem="train", labels=("model",),
)
TRAIN_GRAD_NORM = _r.gauge(
    "grad_norm",
    "Most recent global gradient norm, per model type (pre-clip; a "
    "diverging run shows here steps before the loss does)",
    subsystem="train", labels=("model",),
)
TRAIN_RUNS_TOTAL = _r.counter(
    "runs_total",
    "Training runs by outcome (ok | error | skipped)",
    subsystem="train", labels=("result",),
)
TRAIN_LAST_RUN_LOSS = _r.gauge(
    "last_run_loss",
    "Final loss of the most recent completed run (gnn when trained, else "
    "mlp) — the stats-frame / dftop headline",
    subsystem="train",
)

# per-run curve bound: past this many retained points every other one is
# dropped and the retention stride doubles — deterministic, bounded, and the
# curve keeps its overall shape (classic stride-halving decimation)
_CURVE_CAP = 160


class TrainRunTelemetry:
    """Per-step telemetry sink for ONE model's training inside one run.

    The trainers call on_step() with host-visible losses as they land (the
    MLP every tenth step with the steps since its last report, the GNN once
    per step after each multi-step call's one pull) — each call updates the
    dragonfly_train_* families above and the bounded curve. Thread-safe: the trainers run on worker threads while the
    trainer's event loop answers status RPCs.

    Clock-injected: rates derive from the injected monotonic clock,
    so a virtual-clock harness measures virtual steps/s deterministically.
    """

    def __init__(
        self,
        model: str,
        *,
        batch_size: int = 0,
        clock: Clock | None = None,
    ):
        self.model = model
        self.batch_size = int(batch_size)
        self._clock = clock or SYSTEM
        self._lock = threading.Lock()
        self.steps = 0
        self.examples = 0
        self.last_loss = math.nan
        self.last_grad_norm: float | None = None
        self._curve: list[tuple[int, float]] = []
        self._curve_stride = 1
        # steps/s anchors at the FIRST report, not construction: the gap
        # between them is set-up (model init, the pool's upload, the first
        # call's warm-up), which would understate a short run's throughput.
        # The first report's own steps are excluded too.
        self._t_first: float | None = None
        self._steps_at_first = 0
        self._t_last = self._clock.monotonic()

    def on_step(
        self,
        loss: float,
        grad_norm: float | None = None,
        *,
        steps: int = 1,
        examples: int | None = None,
    ) -> None:
        """Report `steps` completed optimizer steps whose latest loss is
        `loss`. examples defaults to steps x batch_size."""
        n = int(steps)
        ex = int(examples) if examples is not None else n * self.batch_size
        loss = float(loss)
        with self._lock:
            self.steps += n
            self.examples += ex
            self.last_loss = loss
            if grad_norm is not None:
                self.last_grad_norm = float(grad_norm)
            self._t_last = self._clock.monotonic()
            if self._t_first is None:
                self._t_first = self._t_last
                self._steps_at_first = self.steps
            if self.steps % self._curve_stride == 0 or not self._curve:
                self._curve.append((self.steps, loss))
                if len(self._curve) > _CURVE_CAP:
                    self._curve = self._curve[::2]
                    self._curve_stride *= 2
        TRAIN_STEPS_TOTAL.inc(n, model=self.model)
        if ex:
            TRAIN_EXAMPLES_TOTAL.inc(ex, model=self.model)
        TRAIN_LOSS.set(loss, model=self.model)
        if grad_norm is not None:
            TRAIN_GRAD_NORM.set(float(grad_norm), model=self.model)

    def steps_per_sec(self) -> float | None:
        with self._lock:
            return self._steps_per_sec_locked()

    def _steps_per_sec_locked(self) -> float | None:
        if self._t_first is None:
            return None
        wall = self._t_last - self._t_first
        post = self.steps - self._steps_at_first
        if post <= 0 or wall <= 0:
            return None  # one report = no interval to rate over
        return post / wall

    def curve(self) -> list[tuple[int, float]]:
        with self._lock:
            return list(self._curve)

    def summary(self) -> dict:
        """Per-model slice of the run manifest (trainer/service.py)."""
        with self._lock:
            sps = self._steps_per_sec_locked()
            if sps is not None:
                sps = round(sps, 2)
            return {
                "steps": self.steps,
                "examples": self.examples,
                "final_loss": None if math.isnan(self.last_loss) else round(self.last_loss, 6),
                "grad_norm": (
                    None if self.last_grad_norm is None
                    else round(self.last_grad_norm, 6)
                ),
                "steps_per_sec": sps,
                "curve": [(s, round(v, 6)) for s, v in self._curve],
            }
