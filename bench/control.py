#!/usr/bin/env python3
"""Readings that set a cell's ``check`` limits, several seeds in one
process (the card's set-up paid once for Python and CUDA):

    python3 bench/control.py --workload <cell> --seeds 1,2,3 --seconds 20

For each seed it runs the cell as ``run.py`` does and reads, on the same
sample of finished requests, the program's gaps and the float8 control's
(``check.py``).  One JSON line a seed, then for each number the largest
program reading (the lower reading of a limit) and the smallest control
reading (the upper).  ``--float32`` runs the program in float32 as a
witness that the reference computes what the program does.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1])]

from bench import run as R  # noqa: E402  (sets the paths and cache directories)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--float32", action="store_true",
                    help="a witness: the program and its weights in float32")
    a = ap.parse_args(argv)
    from bench import spec
    cell = spec.find_cell(a.workload)
    port_cfg = None
    if a.float32:
        from repro_torch.configs import get_config
        cell.config["torch_dtype"] = "float32"
        port_cfg = get_config(cell.config["port_arch"]).replace(dtype="float32")
    rows = []
    for seed in [int(s) for s in a.seeds.split(",")]:
        res = R.run_cell(cell, seed, a.seconds, False, port_cfg=port_cfg, control=True)
        rows.append(res["window"]["gaps"])
        print(json.dumps({"seed": seed, "gaps": rows[-1], "window": res["window"],
                          "metrics": res["metrics"]}), flush=True)
    keys = [k for k in rows[0] if k.endswith(("gap", "share")) and not k.startswith("control_")]
    print(json.dumps({"workload": a.workload, "float32": a.float32,
                      "lower": {k: max(r[k] for r in rows) for k in keys},
                      "upper": {k: min(r["control_" + k] for r in rows) for k in keys}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
