"""Small asyncio compatibility helpers.

The port's copy of dragonfly2_tpu/utils/aio.py. Before Python 3.11
asyncio.TaskGroup does not exist, and the two fan-out sites that want its
semantics (ranged back-to-source piece fetches, checkpoint multi-file fetch)
must run on 3.10 too. `gather_all_cancel_on_error` provides the one
TaskGroup behavior those sites rely on: run everything, and on the first
failure cancel the stragglers before re-raising (so multi-GB sibling
downloads don't keep running detached after the caller has already failed).
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Iterable

__all__ = ["gather_all_cancel_on_error"]


async def gather_all_cancel_on_error(coros: Iterable[Awaitable]) -> None:
    """Await all coroutines; first failure cancels the rest and re-raises.

    Unlike bare asyncio.gather (which returns control on the first error but
    leaves the remaining tasks running detached), every task is finished or
    cancelled by the time this returns — TaskGroup semantics on any Python. The
    first exception (in completion order) propagates; later ones are eaten,
    as with TaskGroup's primary-error behavior for non-ExceptionGroup users.
    """
    tasks = [asyncio.ensure_future(c) for c in coros]
    if not tasks:
        return
    try:
        await asyncio.gather(*tasks)
    except BaseException:
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        raise
