"""Micro-batching request front over a scorer's multi-round entry.

The port's own copy of dragonfly2_tpu/native/microbatch.py. The scheduler
serves many concurrent AnnouncePeer streams on one asyncio loop; each
scheduling round needs one ~40-candidate scoring call. Scoring rounds one
by one caps throughput at the single-call rate, so under load this facade
queues concurrent rounds and flushes them as ONE ``score_rounds`` call —
one head call (and, for the port's GNNScorer, one trip to the card) per
flush instead of per round.

Design: an explicit flush loop, not per-call timers. A caller appends its
round to the pending list and awaits its future; the single flusher task
drains everything pending in one call, then yields to the loop. Under no
load a round still completes in one loop tick (no artificial latency
floor); under load the queue depth self-adjusts to the arrival rate.
"""

from __future__ import annotations

import asyncio
import os
from typing import Optional

import numpy as np


class MicroBatchScorer:
    """Coalesces concurrent score() calls into multi-round scorer calls.

    All rounds in one flush must share the candidate batch width B (rounds
    are padded up to the widest round in the flush; padding rows reuse index
    0 with zero features and are sliced off on return).
    """

    def __init__(self, scorer, *, max_rounds_per_flush: int = 64):
        self._scorer = scorer  # anything with score_rounds (GNNScorer, NativeScorer)
        self._max_rounds = max_rounds_per_flush
        self._pending: list[tuple[np.ndarray, np.ndarray, np.ndarray, asyncio.Future]] = []
        self._flusher: Optional[asyncio.Task] = None
        # Off-loop flushes only pay off with a second core to run them on:
        # torch releases the GIL inside its ops, so on a multi-core host the
        # loop builds the next flush's features while this one is scored; on
        # a single core the thread hop is overhead.
        self._offload = (os.cpu_count() or 1) > 1
        self.flushes = 0
        self.rounds = 0

    @property
    def ready(self) -> bool:
        return getattr(self._scorer, "ready", False)

    async def score(
        self, pair_feats: np.ndarray, *, child: np.ndarray, parent: np.ndarray
    ) -> np.ndarray:
        """Queue one scoring round; resolves after the next flush."""
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending.append((np.asarray(pair_feats), np.asarray(child), np.asarray(parent), fut))
        if self._flusher is None or self._flusher.done():
            self._flusher = asyncio.create_task(self._flush_loop())
        return await fut

    async def _flush_loop(self) -> None:
        # Yield once so callers scheduled in the same tick can enqueue before
        # the first drain — this is what turns N concurrent rounds into one
        # scorer call instead of N.
        await asyncio.sleep(0)
        while self._pending:
            batch, self._pending = self._pending[: self._max_rounds], self._pending[self._max_rounds :]
            # Validated UP FRONT: the port's GNNScorer rejects the whole flush
            # for one stale node id, so the culprit round must fail alone.
            good = self._validate(batch)
            if not good:
                continue
            try:
                out, widths = await self._score(good)
            except Exception as e:  # broken scorer: fail the flush
                self._fail_all(good, e)
                continue
            self.flushes += 1
            self.rounds += len(good)
            for m, (*_r, fut) in enumerate(good):
                if not fut.done():
                    fut.set_result(out[m, : widths[m]])
            await asyncio.sleep(0)

    async def _score(self, good) -> tuple[np.ndarray, list[int]]:
        if len(good) == 1 or not self._offload:
            # single-round (or single-core) latency path: a thread hop costs
            # more than it buys
            return self._score_assembled(good)
        # Multi-round flush runs OFF the loop thread: the scorer's kernels
        # release the GIL, so the event loop keeps building the NEXT flush's
        # features while this one is scored — scoring and feature assembly
        # pipeline instead of serializing.
        return await asyncio.to_thread(self._score_assembled, good)

    @staticmethod
    def _fail_all(rounds, err: BaseException) -> None:
        for *_r, fut in rounds:
            if not fut.done():
                fut.set_exception(err)

    def _validate(self, batch) -> list:
        """Per-round bounds checks (loop thread — it resolves futures): the
        scorer rejects the whole batch on any bad index, so one round
        carrying a stale node id (e.g. from a pre-refresh graph) must fail
        alone, not take down 63 healthy concurrent rounds. Resolves culprit
        futures with the error and returns the surviving rounds to score."""
        n = self._scorer.num_nodes
        good = []
        for f, c, p, fut in batch:
            if c.min(initial=0) < 0 or p.min(initial=0) < 0 or (
                len(c) and (c.max() >= n or p.max() >= n)
            ):
                if not fut.done():
                    fut.set_exception(
                        ValueError(f"node index out of range for {n}-node artifact")
                    )
            else:
                good.append((f, c, p, fut))
        return good

    def _score_assembled(self, good) -> tuple[np.ndarray, list[int]]:
        """Assembly + the scorer call; pure compute, safe off the loop."""
        fp = self._scorer.feature_dim
        widths = [len(c) for _f, c, _p, _fut in good]
        B = max(widths)
        M = len(good)
        feats = np.zeros((M, B, fp), np.float32)
        child = np.zeros((M, B), np.int32)
        parent = np.zeros((M, B), np.int32)
        for m, (f, c, p, _fut) in enumerate(good):
            feats[m, : widths[m]] = f
            child[m, : widths[m]] = c
            parent[m, : widths[m]] = p
        out = self._scorer.score_rounds(feats, child=child, parent=parent)
        return out, widths
