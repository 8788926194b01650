"""Model (program spans and counters, ``repro_torch/tracing.py``): the
host–device syncs the program made inside its ``decode`` spans (reads to
the host, copies from pageable host memory, stream syncs, as torch's CUDA
sync debug mode reports them), per decode step of the traced sub-window.
None without a device trace, or where the program keeps no tracing
session (one without ``repro_torch.tracing``)."""


def read(run):
    if run.trace is None:
        return None
    try:
        from repro_torch.tracing import last
    except ImportError:
        return None
    s = last()
    n = len(s.find("decode")) if s is not None else 0
    return s.syncs_within("decode") / n if n else None
