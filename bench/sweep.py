#!/usr/bin/env python3
"""The knee of a cell's configuration: its traffic's length laws under
Poisson arrivals at each of a list of rates, one window each, in one
process.

    python3 bench/sweep.py --workload qwen3-burstgpt-mmpp --rates 2,4,8 --seconds 25

For each rate it prints the offered and the served output tokens a second
and the waiting queue at the window's opening and close.  The knee is the
highest rate whose served tokens match the offered ones with a queue that
does not grow; the open-loop traffic file stores it as ``arrival.rps``.
"""
from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1])]

from bench import run as R  # noqa: E402


def main(argv=None) -> int:
    import argparse
    import numpy as np
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=25.0)
    ap.add_argument("--seed", type=int, default=1)
    a = ap.parse_args(argv)
    from bench import spec, traffic
    base = spec.find_cell(a.workload)
    for rps in [float(r) for r in a.rates.split(",")]:
        cell = copy.deepcopy(base)
        cell.traffic["arrival"] = {"process": "poisson", "rps": rps}
        master = np.random.default_rng(cell.traffic["master_seed"])
        mean_out = traffic.output_lens(master, 100000, cell.traffic["output"]).mean()
        res = R.run_cell(cell, a.seed, a.seconds, False)
        print(json.dumps({"rps": rps, "offered_tok_s": rps * mean_out,
                          "served": res["window"], "correct": res["correct"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
