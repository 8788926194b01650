#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``, from process start to the window's opening): the
configuration's weights drawn on the card from the seed, the ``Engine``
built, the kernels loaded (built by nvcc into ``build/repro_torch_kernels``
inside the checkout on a first run), one request at each prefill bucket the
traffic reaches, then ``warmup_s`` of the cell's traffic.  The window then
runs ``--seconds`` of traffic on the wall clock.  With ``--trace 1`` a
sub-window of it runs under the profiler and the per-layer metrics are
printed instead of the end-to-end ones.  After the window the program's
state is freed and the served tokens of a sample of finished requests are
compared with the plain reference (``check.py``).

The last line of standard output is the result; the compared numbers and
their limits are the last lines of standard error.  Exits non-zero with no
result when the card or the cell's chip count is missing, or when JAX or
the JAX package was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "build" / sub)
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
PROFILE_AT = 0.3          # the profiled sub-window starts this share into the window
PROFILE_S = 3.0           # and lasts this long, at most a fifth of the window
PROFILE_TRIES = 3         # traces taken while the profiler hands back empty ones


def clock() -> float:
    return time.perf_counter() - T0


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


class TracePlan:
    """Starts and stops the profiler at step boundaries inside the window;
    a sub-window whose trace holds no device event is taken again."""

    def __init__(self, torch, probe, t_open: float, seconds: float):
        from bench.trace import Profiler
        self.prof = Profiler(torch)
        self.probe = probe
        self.at = t_open + PROFILE_AT * seconds
        self.span = min(PROFILE_S, 0.2 * seconds)
        self.tries = 0
        self.device = None
        self.started = None

    def __call__(self, now: float) -> None:
        if self.started is None:
            if self.device is None and self.tries < PROFILE_TRIES and now >= self.at:
                self.probe.routes.clear()
                self.probe.decode_lengths.clear()
                self.probe.spans.clear()
                self.prof.start()
                self.probe.profiling = True
                self.started = clock()
                self.tries += 1
        elif now >= self.started + self.span:
            self.finish()

    def finish(self) -> None:
        if self.started is None:
            return
        device = self.prof.stop()
        self.probe.profiling = False
        self.started = None
        if device:
            self.device = device
        else:
            log(f"trace: try {self.tries} held no device event; tracing again")
            self.at = clock() + 1.0

    def summary(self):
        from bench.trace import reduce
        return reduce(self.device, self.probe.spans) if self.device else None


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             port_cfg=None, control: bool = False) -> dict:
    """One run of ``cell`` (a ``spec.Cell``); returns the result object.
    ``port_cfg`` replaces the port's own config (the CPU tests' widths);
    ``control`` adds the float8 control's gap on the same sample
    (``bench/control.py``)."""
    import numpy as np
    import torch

    from bench import check, serve, spec, stats, traffic, weights
    from bench.record import Run
    from bench.reference.common import expert_capacity

    config, mix = cell.config, cell.traffic
    cfg = serve.port_config(config, port_cfg)
    eng_cfg = config["engine"]
    max_prompt = eng_cfg["max_seq"] - 1
    on_card = device != "cpu"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    params = weights.program_params(config, seed, device)
    engine = serve.build_engine(config, cfg, params, device)
    del params
    reqs = {}
    probe = serve.Probe(engine, config, reqs, clock)
    lo, hi = traffic.prompt_bounds(mix, max_prompt)
    buckets = serve.warm_shapes(engine, probe, config, lo, hi, seed, clock)
    t_start = clock()
    if mix["loop"] == "open":
        source = serve.OpenSource(traffic.open_loop(mix, seed, config["vocab_size"], max_prompt),
                                  t_start)
    else:
        source = serve.ClosedSource(
            traffic.closed_loop(mix, seed, config["vocab_size"], max_prompt), t_start)
    t_open = t_start + mix["warmup_s"]
    t_close = t_open + seconds
    plan = TracePlan(torch, probe, t_open, seconds) if trace else None
    if plan is not None and on_card:
        plan.prof.warm()
    serve.drive(engine, probe, source, reqs, t_open, clock)
    setup_s = t_open
    queued = [len(engine.queue)]
    serve.drive(engine, probe, source, reqs, t_close, clock, plan or (lambda now: None))
    if plan is not None:
        plan.finish()
    queued.append(len(engine.queue))
    if on_card:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    bounds = probe.kernel_bounds() if trace else {}
    probe.close()
    e2e = stats.end_to_end(reqs, t_open, t_close)
    attempted = [r for r in reqs.values() if t_open <= r.due < t_close]
    failed = sum(r.refused for r in attempted)
    finished = [(r.rid, r.prompt[:max_prompt], r.served) for r in reqs.values()
                if r.finished is not None]
    mismatch = sum(len(r.served) != len(r.stamps) for r in reqs.values() if r.finished)
    c = config["check"]
    samples = check.sample(finished, seed, c["min_tokens"], c["max_requests"])
    drops = probe.decode_drops([f[0] for f in samples], {f[0]: len(f[1]) for f in samples},
                               expert_capacity(config, eng_cfg["max_slots"]))
    cap_mismatch = probe.capacity_mismatches(seed)
    unseen = probe.routes_unseen()
    relocations = engine.backend.relocations
    t_read = clock()
    run = Run(config, mix, t_open, t_close, probe.steps, reqs,
              plan.summary() if plan else None, bounds)
    if trace:
        log(f"trace: {plan.tries} sub-window(s) traced, read in {clock() - t_read:.2f} s"
            + (f"; device s outside the host window {run.trace.outside_s:.6f}"
               if run.trace is not None else ""))
    n_steps = len(run.window_steps())
    n_dropped = sum(len(v) for d in drops.values() for layer in d.values() for v in layer.values())
    del engine, probe, plan          # the trace plan holds the probe, and so the engine
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_check = clock()
    got = check.gaps(config, seed, samples, device, control,
                     [drops[f[0]] for f in samples]) if samples else dict(
        check.summary(np.full(1, np.inf), ""), tokens=0, requests=0)
    log(f"check: {got['requests']} requests, {got['tokens']} served tokens against the "
        f"reference in {clock() - t_check:.1f} s ({n_dropped} expert selections their "
        f"decode steps dropped); {len(finished)} finished, {n_steps} steps in the window, "
        f"{buckets} buckets warmed")
    checks = {k: {"value": got[k], "limit": c[k]} for k in check.compared(c)}
    checks.update({"token_count_mismatch": {"value": mismatch, "limit": 0},
              "capacity_position_mismatch": {"value": cap_mismatch, "limit": 0},
              "decode_routes_unseen": {"value": unseen, "limit": 0}})
    correct = bool(samples) and all(v["value"] <= v["limit"] for v in checks.values())

    if trace:
        metrics = spec.read_metrics(cell, run)
    else:
        # ``<base>.<part>`` is ``<base>`` under a cell's own name and bound
        e2e["setup_s"] = setup_s
        metrics = {m["name"]: {"value": e2e[m["name"].split(".")[0]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"].split(".")[0] in e2e}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if on_card:
        dev["power_limit"] = power_limit()
    result = {"correct": correct, "attempted": len(attempted), "failed": int(failed),
              "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    # counts beside the result: the window's queue and work, and the TTFTs
    result["window"] = {"queued_at_open": queued[0], "queued_at_close": queued[1],
                        "finished": len(finished), "steps": n_steps,
                        "end_to_end": {k: v for k, v in e2e.items() if k != "setup_s"},
                        "served_tokens_compared": got["tokens"],
                        "logit_gaps": {k: got[k] for k in check.summary(np.zeros(1), "")},
                        "decode_drops_followed": n_dropped, "relocations": relocations}
    if control:
        result["window"]["gaps"] = got
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    from bench import spec
    cell = spec.find_cell(a.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"needs {cell.chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(cell, a.seed, a.seconds, bool(a.trace))
    bad = forbidden_modules()
    if bad:
        log(f"loaded in this process: {bad}; the benchmark runs the port alone")
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
