"""Serving driver of the port, from ``repro.launch.serve``:

    python -m repro_torch.launch.serve [--arch ID] [--variant V] [--engines N]
        [--trace burstgpt|sharegpt] [--n N] [--rps R] [--fail-engine I]
        [--device cuda|cpu]

A cluster of real engines on a reduced (smoke) config serving a BurstGPT-
or ShareGPT-shaped trace with the full Gimbal stack, health monitoring and
an optional engine failure, on the reference's logical clock (0.05 s a
step).  Engine i's weights are ``init_params(cfg, seed=i)``.  The engines
run on the card unless ``device="cpu"``.  It prints the reference's lines:
each failure and re-route as it happens, then the report and the prefix
and relocation counts.
"""
from __future__ import annotations

import argparse
import copy
from typing import List, Tuple

from repro_torch.configs import get_smoke_config, list_archs
from repro_torch.core.types import GimbalConfig
from repro_torch.distributed.fault import HealthConfig, HealthMonitor
from repro_torch.launch.mesh import refuse_fake_group
from repro_torch.models import model as M
from repro_torch.serving.cluster import Cluster
from repro_torch.serving.engine import Engine
from repro_torch.workloads.burstgpt import burstgpt_trace
from repro_torch.workloads.sharegpt import sharegpt_trace

DT = 0.05            # logical seconds a cluster step
HORIZON = 120.0      # logical seconds after which the loop stops


def build_cluster(arch: str, variant: str, n_engines: int, gcfg: GimbalConfig,
                  device=None) -> Cluster:
    cfg = get_smoke_config(arch)
    engines = []
    for i in range(n_engines):
        params = M.init_params(cfg, seed=i, device=device)
        engines.append(Engine(i, cfg, params, variant=variant, gimbal_cfg=gcfg,
                              max_slots=4, max_seq=128, prefill_budget=128,
                              num_expert_devices=max(2, min(4, cfg.num_experts or 2)),
                              device=device))
    return Cluster(engines, variant=variant, gimbal_cfg=gcfg)


def make_trace(kind: str, n: int, rps: float) -> list:
    """The reference's traces, scaled to the smoke configs: BurstGPT prompts
    / 50 (at least 8 tokens) and outputs / 40 (at least 2); ShareGPT
    sessions over a 64-token vocabulary, 2 new tokens a turn."""
    if kind == "burstgpt":
        trace = burstgpt_trace(n=n, rps=rps, seed=0)
        for r in trace:
            r.prompt_len = max(8, r.prompt_len // 50)
            r.max_new_tokens = max(2, r.max_new_tokens // 40)
    else:
        trace = sharegpt_trace(n_requests=n, n_users=max(n // 8, 1), rps=rps,
                               vocab_size=64, utterance_mean=12, answer_mean=8,
                               max_context=96)
        for r in trace:
            r.max_new_tokens = 2
    return [copy.copy(r) for r in trace]


def serve(arch: str = "qwen3-30b-a3b", variant: str = "gimbal", engines: int = 2,
          trace: str = "burstgpt", n: int = 40, rps: float = 20.0,
          fail_engine: int = -1, device=None) -> Tuple[Cluster, List[str]]:
    """Run the serving loop to the end; every line is printed and returned
    in a list, beside the cluster."""
    lines: List[str] = []

    def say(line: str) -> None:
        lines.append(line)
        print(line)

    refuse_fake_group("serve")
    gcfg = GimbalConfig(tau=25, theta_load=64)
    cluster = build_cluster(arch, variant, engines, gcfg, device=device)
    monitor = HealthMonitor(list(cluster.engines), HealthConfig())
    reqs = make_trace(trace, n, rps)

    i, now = 0, 0.0
    failed_at = None
    while True:
        while i < len(reqs) and reqs[i].arrival_time <= now:
            cluster.submit(reqs[i], now)
            i += 1
        cluster.step(now)
        monitor.observe(cluster.bus.snapshot(now), now)
        for eid in monitor.check(now):
            say(f"[serve] t={now:.2f} engine {eid} DEAD -> re-routing")
            cluster.fail_engine(eid, now)
        if fail_engine >= 0 and failed_at is None and i >= len(reqs) // 2:
            say(f"[serve] t={now:.2f} injecting failure of engine {fail_engine}")
            moved = cluster.fail_engine(fail_engine, now)
            say(f"[serve] re-routed {moved} requests")
            failed_at = now
        now += DT
        if i >= len(reqs) and all(
                e.num_active() == 0 and len(e.queue) == 0
                for e in cluster.engines.values() if e.healthy):
            break
        if now > HORIZON:
            break

    rep = cluster.report()
    pf = cluster.prefix_stats()
    relocs = sum(e.relocations for e in cluster.engines.values())
    say(f"[serve] {variant} on {arch}: {rep.n}/{len(reqs)} done | "
        f"TTFT mean {rep.mean_ttft:.3f}s p99 {rep.p99_ttft:.3f}s | "
        f"TPOT {rep.mean_tpot*1e3:.1f}ms | {rep.throughput_tok_s:.0f} tok/s")
    say(f"[serve] prefix hits {pf['hit_blocks']} "
        f"(rate {100*pf['hit_rate']:.1f}%) | expert relocations {relocs}")
    return cluster, lines


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-30b-a3b", choices=list_archs())
    ap.add_argument("--variant", default="gimbal",
                    choices=["vllm", "dplb", "sjfs", "edr", "gimbal"])
    ap.add_argument("--engines", type=int, default=2)
    ap.add_argument("--trace", default="burstgpt", choices=["burstgpt", "sharegpt"])
    ap.add_argument("--n", type=int, default=40)
    ap.add_argument("--rps", type=float, default=20.0)
    ap.add_argument("--fail-engine", type=int, default=-1,
                    help="inject a failure of this engine mid-run")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()
    serve(args.arch, args.variant, args.engines, args.trace, args.n, args.rps,
          args.fail_engine, device=args.device)


if __name__ == "__main__":
    main()
