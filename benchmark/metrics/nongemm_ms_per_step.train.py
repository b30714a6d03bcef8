"""Device milliseconds a training step spends in kernels that are not
matrix products (benchmark/gemm_kernels.json), in the profiled slice."""


def read(run):
    steps = run.host.get("slice_steps", 0)
    if run.trace is None or not steps:
        return None
    return run.trace["nongemm_s"] / steps * 1e3
