"""The training step's share of the card's bf16 dense peak: the matrix
products a step needs (benchmark/flops.py) over the time per step of the
traced run's calls outside the profiled slice, host clock from each
call's start to its pull."""

from benchmark import flops


def read(run):
    steps, seconds = run.host.get("plain_steps", 0), run.host.get("call_s", 0.0)
    if not steps or seconds <= 0 or not run.peaks:
        return None
    return 100.0 * flops.train_step(run.config) * steps / seconds / run.peaks["bf16_flops"]
