"""Model (program spans, ``repro_torch/tracing.py``): wall ms of one model
layer inside the program's ``decode`` spans, on the host clock under the
profiler: the summed ``layer`` spans under ``decode`` over their count
(decode steps × layers).  None without a device trace or a tracing
session."""


def read(run):
    if run.trace is None:
        return None
    try:
        from repro_torch.tracing import last
    except ImportError:
        return None
    s = last()
    n = s.count_within("layer", "decode") if s is not None else 0
    return 1e-6 * s.ns_within("layer", "decode") / n if n else None
