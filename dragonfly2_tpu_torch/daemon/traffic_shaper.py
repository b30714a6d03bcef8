"""Node-wide sampling traffic shaper (the port of
dragonfly2_tpu/daemon/traffic_shaper.py).

Parity with the reference's NewSamplingTrafficShaper
(client/daemon/peer/traffic_shaper.go:139): ONE host-wide download budget
(default 1 GiB/s, client/config/constants.go:46) shared by all concurrent
task conductors, reallocated every sampling interval by each task's observed
need — an idle task's bandwidth flows to the busy ones. Without this, N
concurrent tasks each carrying their own 512 MB/s bucket oversubscribe the
host N×.

Redesign vs the reference: no background goroutine — resampling happens
lazily on the acquire path once the interval elapses (single-threaded asyncio
makes this race-free and testable without a timer task). Observed issuance
alone can't reveal a starved flow's true need (a conductor acquires serially,
so it can only issue what its current allocation grants); a flow that is
BLOCKED in its bucket at sample time is saturated, and its need is taken as a
multiple of its current rate — multiplicative ramp, so a starved flow reaches
any allocation within a few intervals instead of creeping up additively.

Allocation per resample: every flow keeps a guaranteed floor; the spare
budget is split proportionally to observed need; per-flow caps (the 512 MB/s
per-peer limit) redistribute their excess to uncapped flows. Flows younger
than one full interval count as max-need so new downloads ramp immediately.

Tenant priorities (`open_flow(..., weight=)`): each flow's share of the
CONTENDED budget scales by its weight, so two saturated tasks with weights
1 and 3 converge to a 1:3 bandwidth split. For this to be a stable fixed
point, a saturated flow's demand is taken as the PER-FLOW CAP rather than a
multiple of its current rate — ramping off the current rate made allocation
proportional to prior allocation, which compounds every interval and only
stops at the floor/cap rails (the weighted split would never converge to
the weights). Demand-capped shares converge in one resample and still ramp
a starved flow instantly (cap >> anything it had).
"""

from __future__ import annotations

import logging
import time

from dragonfly2_tpu_torch.utils.ratelimit import TokenBucket

logger = logging.getLogger(__name__)

TOTAL_DOWNLOAD_RATE_BPS = float(1 << 30)  # ref constants.go:46
PER_FLOW_CAP_BPS = float(512 << 20)  # ref constants.go:45


class Flow:
    """One task's slice of the host budget; quacks like TokenBucket.acquire."""

    def __init__(
        self,
        shaper: "SamplingTrafficShaper",
        flow_id: str,
        bucket: TokenBucket,
        weight: float = 1.0,
    ):
        self._shaper = shaper
        self.flow_id = flow_id
        self.bucket = bucket
        # tenant priority: scales this flow's share of contended bandwidth
        self.weight = max(1e-6, float(weight))
        self.created_at = time.monotonic()
        self.window_bytes = 0.0  # demand since last resample
        self.pending_bytes = 0.0  # blocked in the bucket right now
        self.blocked_in_window = False  # hit an empty bucket since last sample
        self.consumed_bytes = 0.0  # lifetime, for metrics/tests
        self.closed = False

    @property
    def rate_bps(self) -> float:
        return self.bucket.rate

    @property
    def saturated(self) -> bool:
        """The flow wanted more than its allocation granted this window.
        Both signals matter: pending_bytes catches a flow blocked at the
        moment ANOTHER flow triggers the resample; the sticky window flag
        catches the flow's own past blocks (its own trigger point always has
        pending == 0 — conductors acquire serially)."""
        return self.pending_bytes > 0 or self.blocked_in_window

    async def acquire(self, n: float) -> None:
        self.window_bytes += n
        self._shaper.maybe_resample()
        if self.bucket.try_acquire(n):
            self.consumed_bytes += n
            return
        self.blocked_in_window = True
        self.pending_bytes += n
        try:
            await self.bucket.acquire(n)
        finally:
            self.pending_bytes -= n
        self.consumed_bytes += n

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            self._shaper._unregister(self)


class SamplingTrafficShaper:
    def __init__(
        self,
        *,
        total_rate_bps: float = TOTAL_DOWNLOAD_RATE_BPS,
        per_flow_cap_bps: float = PER_FLOW_CAP_BPS,
        min_flow_rate_bps: float = 4 << 20,
        interval_s: float = 1.0,
    ):
        if total_rate_bps <= 0:
            raise ValueError("total_rate_bps must be > 0")
        self.total_rate_bps = float(total_rate_bps)
        self.per_flow_cap_bps = min(float(per_flow_cap_bps), self.total_rate_bps)
        self.min_flow_rate_bps = max(1.0, min(float(min_flow_rate_bps), self.per_flow_cap_bps))
        self.interval_s = float(interval_s)
        self._flows: dict[str, Flow] = {}
        self._last_sample = time.monotonic()
        self._last_needs: dict[str, float] = {}  # carried into out-of-band reallocs
        self.resamples = 0

    # ---- flow lifecycle ----

    def open_flow(self, flow_id: str, *, weight: float = 1.0) -> Flow:
        """Register a task download; triggers an immediate reallocation so
        the newcomer gets headroom without waiting a full interval. `weight`
        is the task's tenant priority (module docstring): contended
        bandwidth splits weight-proportionally."""
        bucket = TokenBucket(self.min_flow_rate_bps, burst=self.min_flow_rate_bps / 2)
        flow = Flow(self, flow_id, bucket, weight=weight)
        self._flows[flow_id] = flow
        # Out-of-band reallocation carries the LAST sampled needs: a task
        # arriving must not zero the established flows' weights and collapse
        # them to the floor for a whole interval (the newcomer weighs in at
        # max-need via the young-flow rule regardless).
        self._reallocate(self._last_needs)
        return flow

    def _unregister(self, flow: Flow) -> None:
        self._flows.pop(flow.flow_id, None)
        self._last_needs.pop(flow.flow_id, None)
        if self._flows:
            self._reallocate(self._last_needs)

    # ---- sampling + allocation ----

    def maybe_resample(self, now: float | None = None) -> bool:
        now = time.monotonic() if now is None else now
        elapsed = now - self._last_sample
        if elapsed < self.interval_s:
            return False
        needs = {}
        for fid, f in self._flows.items():
            need = f.window_bytes / elapsed
            if f.saturated:
                # Blocked in its bucket → wants more than granted, and
                # issuance only shows what the old allocation permitted.
                # Demand is taken as the per-flow cap: the starved flow
                # reaches any allocation in ONE resample, and (unlike a
                # rate-multiple ramp) the weighted split over cap-demands is
                # a stable fixed point at the configured weights.
                need = self.per_flow_cap_bps
            needs[fid] = need
        for f in self._flows.values():
            f.window_bytes = 0.0
            f.blocked_in_window = False
        self._last_sample = now
        self._last_needs = needs
        self._reallocate(needs, now=now)
        self.resamples += 1
        return True

    def _reallocate(self, needs: dict[str, float], now: float | None = None) -> None:
        flows = list(self._flows.values())
        if not flows:
            return
        now = time.monotonic() if now is None else now
        n = len(flows)
        floor = min(self.min_flow_rate_bps, self.total_rate_bps / n)
        spare = self.total_rate_bps - floor * n
        # Share weight = observed need (flows younger than a full interval
        # weigh in at the per-flow cap — no meaningful sample yet) scaled by
        # the flow's tenant priority: contended bandwidth converges to the
        # weight ratio because saturated flows all demand the same cap.
        weights = {}
        for f in flows:
            if now - f.created_at < self.interval_s:
                need = self.per_flow_cap_bps
            else:
                need = needs.get(f.flow_id, 0.0)
            weights[f.flow_id] = need * f.weight
        total_w = sum(weights.values())

        alloc = {f.flow_id: floor for f in flows}
        if spare > 0:
            if total_w <= 0:
                for f in flows:
                    alloc[f.flow_id] += spare / n
            else:
                # proportional split with cap redistribution: capped flows'
                # excess flows back to the uncapped ones (a few passes reach
                # the fixed point; n is small — concurrent tasks on one host)
                remaining = spare
                active = {f.flow_id: weights[f.flow_id] for f in flows}
                for _ in range(4):
                    w_sum = sum(active.values())
                    if remaining <= 1e-9 or w_sum <= 0:
                        break
                    overflow = 0.0
                    granted = remaining
                    remaining = 0.0
                    for fid in list(active):
                        share = granted * active[fid] / w_sum
                        new = alloc[fid] + share
                        if new > self.per_flow_cap_bps:
                            overflow += new - self.per_flow_cap_bps
                            alloc[fid] = self.per_flow_cap_bps
                            del active[fid]
                        else:
                            alloc[fid] = new
                    remaining = overflow
        for f in flows:
            rate = max(1.0, min(alloc[f.flow_id], self.per_flow_cap_bps))
            f.bucket.set_rate(rate, burst=max(rate / 2, 64 << 10))

    # ---- introspection ----

    def allocations(self) -> dict[str, float]:
        return {fid: f.bucket.rate for fid, f in self._flows.items()}

    def __len__(self) -> int:
        return len(self._flows)
