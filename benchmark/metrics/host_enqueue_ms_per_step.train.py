"""Host milliseconds a training step takes to enqueue: a call's start to its
return, before its pull, over the call's steps; calls outside the
profiled slice. Near the time per step, the host does not keep ahead of
the card."""


def read(run):
    steps = run.host.get("plain_steps", 0)
    return run.host["enqueue_s"] / steps * 1e3 if steps else None
