"""Peer-daemon Prometheus metrics (ref client/daemon/metrics/metrics.go): the
port's copy of dragonfly2_tpu/daemon/metrics.py, the same names and labels in
the port's registry.

Counters for task outcomes, piece sources (p2p parent vs back-to-source),
byte traffic both directions, and proxy decisions; gauges for in-flight work.
"""

from __future__ import annotations

from dragonfly2_tpu_torch.observability.metrics import default_registry

_r = default_registry()

TASK_TOTAL = _r.counter(
    "task_total", "Download tasks started", subsystem="dfdaemon", labels=("type",)
)
TASK_RESULT_TOTAL = _r.counter(
    "task_result_total", "Download task completions", subsystem="dfdaemon", labels=("success",)
)
PIECE_DOWNLOAD_TOTAL = _r.counter(
    "piece_download_total", "Pieces fetched", subsystem="dfdaemon", labels=("source",)
)
DOWNLOAD_BYTES = _r.counter(
    "download_bytes_total", "Bytes downloaded (p2p + source)", subsystem="dfdaemon"
)
UPLOAD_BYTES = _r.counter(
    "upload_bytes_total", "Piece bytes served to children", subsystem="dfdaemon"
)
CONCURRENT_TASKS = _r.gauge("concurrent_tasks", "Tasks in flight", subsystem="dfdaemon")
PROXY_REQUEST_TOTAL = _r.counter(
    "proxy_request_total", "Proxy requests", subsystem="dfdaemon", labels=("via",)
)
SEED_TASK_TOTAL = _r.counter("seed_task_total", "Seed tasks triggered", subsystem="dfdaemon")
# crash-safe restart accounting: tasks re-announced at boot, pieces that
# survived the recovery audit, and claimed pieces the audit dropped
# (torn/unverifiable) — the suite's proof that recovered pieces never ride
# the wire again hangs off these plus PIECE_DOWNLOAD_TOTAL deltas
TASK_RECOVERED_TOTAL = _r.counter(
    "task_recovered_total", "Tasks re-announced after restart",
    subsystem="dfdaemon", labels=("state",),
)
# ---- data-plane TLS (security/transport.py + rawrange/upload wiring) ----
# resumed="true" rides the abbreviated handshake (cached session accepted by
# the parent); "false" is a full ECDHE+cert exchange. The alert plane watches
# the failure family: a parent fleet refusing handshakes (cert rollover gone
# wrong, cipher mismatch) shows up here long before piece failures dominate.
PIECE_TLS_HANDSHAKES_TOTAL = _r.counter(
    "piece_tls_handshakes_total", "Data-plane TLS handshakes completed",
    subsystem="dfdaemon", labels=("resumed",),
)
PIECE_TLS_HANDSHAKE_FAILURES_TOTAL = _r.counter(
    "piece_tls_handshake_failures_total",
    "Data-plane TLS handshakes that failed", subsystem="dfdaemon",
)
# one-hot active piece cipher ({cipher="aes-gcm"|"chacha20"|"plain"}): set at
# engine boot so dftop can label piece MB/s with the wire posture
PIECE_CIPHER = _r.gauge(
    "piece_cipher", "Active piece-plane cipher policy (one-hot)",
    subsystem="dfdaemon", labels=("cipher",),
)
# ---- striped multi-parent fetch (conductor) ----
PIECE_STRIPE_PARENTS = _r.histogram(
    "piece_stripe_parents",
    "Distinct parents that served pieces for one completed P2P task",
    subsystem="dfdaemon", buckets=(1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 16.0),
)
PIECE_STEALS_TOTAL = _r.counter(
    "piece_steals_total",
    "Tail pieces re-fetched from a faster parent (slowest-stripe steal)",
    subsystem="dfdaemon", labels=("won",),
)
# ---- adaptive write-behind (conductor WriteBehindGovernor) ----
# one-hot mode ({mode}): measuring | inline | deferred | forced_inline |
# forced_deferred; the decision inputs ride the stage gauge alongside so a
# dashboard can show WHY the governor chose what it chose
WRITE_BEHIND_MODE = _r.gauge(
    "write_behind_mode", "Write-behind decision state (one-hot)",
    subsystem="dfdaemon", labels=("mode",),
)
WRITE_BEHIND_STAGE_MS = _r.gauge(
    "write_behind_stage_ms",
    "First-round per-stage totals the write-behind decision was made from",
    subsystem="dfdaemon", labels=("stage",),
)
PIECE_RECOVERED_TOTAL = _r.counter(
    "piece_recovered_total", "Pieces verified back in at boot", subsystem="dfdaemon"
)
PIECE_DROPPED_RECOVERY_TOTAL = _r.counter(
    "piece_dropped_recovery_total",
    "Claimed pieces dropped by the recovery audit", subsystem="dfdaemon",
)
