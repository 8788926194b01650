#!/usr/bin/env python3
"""Count torch.profiler traces that come back without any device event.

    python3 tools/profiler_probe.py [--traces N]

On one NVIDIA card, takes N short traces in each of three modes, each
trace the window that ``chip_smoke.Timer.device_rows`` traces (the L2
flush and one router call, five times; the router at llama4-maverick's
E = 128, k = 1, T = 512, identity tables), and prints one JSON line per
mode with the number of traces that held no device event at all:

  back_to_back   traces one after another;
  after_host_us  each trace right after ``Timer.host_us`` (200 router calls
                 enqueued with no synchronize);
  settled        a synchronize and a 50 ms pause inside the profiler, before
                 the traced calls.

Ends with the card's name and power limit.  Exits non-zero when there is
no CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MODES = ("back_to_back", "after_host_us", "settled")


def _trace(torch, timer, fn, settle: bool, iters: int = 5) -> int:
    """Device events in one trace of ``iters`` flushes and calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if settle:
            torch.cuda.synchronize()
            time.sleep(0.05)
        for _ in range(iters):
            timer.flush.zero_()
            fn()
        torch.cuda.synchronize()
    return sum(1 for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--traces", type=int, default=200)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profiler_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import topk_router_replicated
    from repro_torch.models.moe import ExpertPlacement

    e, k, t = 128, 1, 512
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    timer = cs.Timer(torch)
    plc = ExpertPlacement.identity(e, device="cuda")
    logits = cs._router_logits(torch, gen, t, e, "random")

    def call():
        return topk_router_replicated(logits, k, plc.replica_slots, plc.replica_count, e)

    call()
    torch.cuda.synchronize()
    for mode in MODES:
        empty, t0 = 0, time.perf_counter()
        for _ in range(a.traces):
            if mode == "after_host_us":
                timer.host_us(call)
            empty += _trace(torch, timer, call, settle=mode == "settled") == 0
        print(json.dumps({"mode": mode, "traces": a.traces, "empty_traces": empty,
                          "seconds": round(time.perf_counter() - t0, 3)}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
