"""A refresh's share of the card's bf16 dense peak: the encoder's and the
head partials' matrix products (benchmark/flops.py) over the time per
refresh of the traced run's refreshes outside the profiled slice."""

from benchmark import flops


def read(run):
    count, seconds = run.host.get("plain_refreshes", 0), run.host.get("refresh_s", 0.0)
    if not count or seconds <= 0 or not run.peaks:
        return None
    return 100.0 * flops.refresh(run.config) * count / seconds / run.peaks["bf16_flops"]
