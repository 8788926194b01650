#!/usr/bin/env python3
"""Time the port's fused MoE router (kernels 2 and 5) on one NVIDIA card.

    python3 tools/bench_router.py [--src DIR] [--label NAME] [--sweep]

Imports ``repro_torch`` from DIR (default: this checkout's ``src``), so
that two trees of the port can be compared on one card in one run,
each in its own process, in turns (parent, change, change, parent).  At
T = 8, 512 and 1024 router tokens x E = 128, k = 8 (qwen3-30b-a3b), for
kernel 2 with identity tables (the paged path) and with R = 8 replica
tables (S = 136), and for kernel 5 (identity placement), prints one JSON
line per case: timed ms (``chip_smoke.Timer``: CUDA events, median of 20
calls, L2 flushed before each), device us and kernel launches per call
(torch.profiler), host us per call (median of 200 calls on the host
clock with no synchronize), ``launch_floor_ms`` (one single-element ``zero_()`` under the
same Timer) and, where the tree has ``route_plan``, the plan.  ``--sweep``
also times every cluster size n = 1, 2, 4, 8 at T = 512 and 1024 (trees
with ``route_plan`` only).  Ends with the card's name and power limit.
Exits non-zero when there is no CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--sweep", action="store_true")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_router: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(a.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import importlib

    import chip_smoke as cs
    from repro_torch.kernels import topk_router, topk_router_replicated
    from repro_torch.models.moe import ExpertPlacement

    router_mod = importlib.import_module("repro_torch.kernels.topk_router")

    plan_of = getattr(router_mod, "route_plan", None)
    e, k = 128, 8
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    timer = cs.Timer(torch)
    one = torch.zeros(1, device="cuda")
    floor = timer.ms(lambda: one.zero_())
    tables = {"identity tables": ExpertPlacement.identity(e, device="cuda"),
              "R=8": cs._router_placement(torch, e, gen), "kernel 5": None}

    def measure(t, name, plc, **over):
        logits = cs._router_logits(torch, gen, t, e, "random")
        kw = {"plan": plan_of(t, e, k, e if plc is None else plc.num_slots, **over)} \
            if over else {}
        if plc is None:
            def call():
                return topk_router(logits, k, **kw)
        else:
            def call():
                return topk_router_replicated(logits, k, plc.replica_slots,
                                              plc.replica_count, plc.num_slots, **kw)
        rows = timer.device_rows(call)
        plan = None
        if plan_of is not None:
            plan = list(kw["plan"] if kw else
                        plan_of(t, e, k, e if plc is None else plc.num_slots))
        print(json.dumps({
            "label": a.label, "T": t, "tables": name, "plan": plan,
            "ms": timer.ms(call), "launch_floor_ms": floor,
            "device_us": sum(us for _, us, _ in rows),
            "launches_per_call": sum(c for _, _, c in rows) / 20,
            "kernels": [key.rsplit("(", 1)[0][-60:] for key, _, _ in rows],
            "host_us": timer.host_us(call)}), flush=True)

    for t in (8, 512, 1024):
        for name, plc in tables.items():
            measure(t, name, plc)
    if a.sweep and plan_of is not None:
        for t in (512, 1024):
            for n in (1, 2, 4, 8):
                measure(t, "identity tables", tables["identity tables"], ctas=n)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
