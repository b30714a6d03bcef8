"""Device milliseconds a refresh spends in kernels that are not matrix
products (benchmark/gemm_kernels.json), in the profiled slice."""


def read(run):
    count = run.host.get("slice_refreshes", 0)
    if run.trace is None or not count:
        return None
    return run.trace["nongemm_s"] / count * 1e3
