"""The port's dry run: build the store of every (arch x shape x mesh) cell
on the production meshes and run the cell's step once on the meta device,
as rank 0 of a fake process group, ported from ``repro.launch.dryrun``.

The reference lowers and compiles each cell with XLA on 512 forced host
devices and reads the compiled program.  The port has no compiler to ask,
so it runs what a rank of the port would run, with shapes only:

  * a fake process group (``torch.testing._internal.distributed.fake_pg``)
    of 256 or 512 ranks, started only here, in the dry run's own process
    (everything else that runs collectives refuses it, and the dry run
    refuses to start beside a real group): its collectives return at once;
  * the store (``distributed/sharding.py``) of the params, the cache or the
    AdamW state and the batch on the meta device, cut by the cell's specs;
  * one ctx'd step (``launch/steps.py``) on it, with the MoE stats off.
    The batch is stored cut by its specs, so the step computes on the
    rank's block of the global batch, as the reference's GSPMD does;
    ``--batch-whole`` runs the cell with no batch axes (every rank holds
    and computes the whole batch), for comparison.

Per cell it records:
  * per-rank argument and output bytes: the local bytes of the step's
    inputs that an operator reads (``jax.jit`` prunes the others, and the
    record names them) and of its outputs, the outputs plus the 8-byte
    pointer a leaf of XLA's output tuple, so both equal XLA's
    ``argument_size_in_bytes`` and ``output_size_in_bytes`` where the
    layouts agree;
  * the peak bytes a rank holds while the step runs
    (``torch.distributed._tools.mem_tracker.MemTracker``, the store
    included);
  * per-rank FLOPs (``torch.utils.flop_counter.FlopCounterMode``) and the
    bytes every operator reads and writes, unfused;
  * per-rank collective wire bytes: each collective the rank issues,
    through the reference's ring formulas over its group size;
  * ``model_flops`` and the roofline terms with the H100's constants.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-72b --cell decode_32k [--multi-pod]
      [--depth D] [--batch-whole]
  python -m repro_torch.launch.dryrun --all [--jobs 4] [--meshes both]
  python -m repro_torch.launch.dryrun --table [--out DIR]

Records go to ``build/dryrun/<arch>__<cell>__<mesh>[__depth<d>][__batch-whole].json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict

import torch

ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"

# NVIDIA H100 SXM5 (the card the port runs on), from NVIDIA's H100 Tensor
# Core GPU datasheet: dense bf16 tensor-core rate, HBM3 bandwidth, and
# NVLink 4 at 900 GB/s per GPU both ways (450 GB/s each way), which the NVLink
# Switch System extends to 256 GPUs.  A ring sends each device's wire bytes
# one way.
PEAK_FLOPS = 989e12        # bf16 FLOP/s per card
HBM_BW = 3.35e12           # bytes/s per card
LINK_BW = 450e9            # bytes/s per card, one direction of NVLink

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# torch.distributed's collectives the port calls -> (reference op name, which
# positional argument is the output)
_CALLS = {"all_reduce": ("all-reduce", 0),
          "all_gather_single": ("all-gather", 0),
          "all_gather_into_tensor": ("all-gather", 0),
          "reduce_scatter_single": ("reduce-scatter", 0),
          "reduce_scatter_tensor": ("reduce-scatter", 0),
          "all_to_all_single": ("all-to-all", 0)}


def wire_bytes(op: str, out_bytes: int, g: int) -> float:
    """Per-device wire bytes of one collective over a group of ``g`` with
    an output of ``out_bytes``, by the reference's ring conventions:

      all-reduce          2*(g-1)/g * out_bytes   (reduce-scatter + all-gather)
      all-gather            (g-1)/g * out_bytes
      reduce-scatter        (g-1)/g * out_bytes * g      (input leaves the node)
      all-to-all            (g-1)/g * out_bytes
      collective-permute              out_bytes
    """
    g = max(g, 2)
    ring = (g - 1) / g
    if op == "all-reduce":
        return 2.0 * ring * out_bytes
    if op == "reduce-scatter":
        return ring * out_bytes * g
    if op == "collective-permute":
        return float(out_bytes)
    return ring * out_bytes


class CollectiveBytes:
    """Counts the collectives this rank issues while active, with their
    wire bytes ({op: wire bytes, "total", "counts"}, as the reference's
    ``parse_collective_bytes``)."""

    def __init__(self):
        self.bytes = {c: 0.0 for c in _COLLECTIVES}
        self.counts = {c: 0 for c in _COLLECTIVES}
        self.log = []            # (op, output bytes, wire bytes, group) per call
        self._saved = {}

    def _wrap(self, fn, op: str, out_arg: int):
        import torch.distributed as dist

        def call(*args, **kw):
            out = args[out_arg] if len(args) > out_arg else kw["tensor"]
            group = kw.get("group")
            n = out.numel() * out.element_size()
            wire = wire_bytes(op, n, dist.get_world_size(group))
            self.bytes[op] += wire
            self.counts[op] += 1
            self.log.append((op, n, wire, group))
            return fn(*args, **kw)
        return call

    def __enter__(self):
        import torch.distributed as dist
        for name, (op, out_arg) in _CALLS.items():
            fn = getattr(dist, name, None)
            if fn is not None:
                self._saved[name] = fn
                setattr(dist, name, self._wrap(fn, op, out_arg))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        for name, fn in self._saved.items():
            setattr(dist, name, fn)

    def record(self) -> dict:
        out: Dict[str, Any] = dict(self.bytes)
        out["total"] = sum(self.bytes.values())
        out["counts"] = dict(self.counts)
        return out


def _op_bytes_mode():
    """A dispatch mode summing the bytes every operator reads and writes
    (its tensor arguments and results, unfused), and noting which tensors
    an operator read (``seen``, by ``id``)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class OpBytes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.total, self.seen = 0, set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_leaves((args, kwargs)):
                if isinstance(t, torch.Tensor):
                    self.seen.add(id(t))
                    self.total += t.numel() * t.element_size()
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self.total += t.numel() * t.element_size()
            return out

    return OpBytes()


def model_flops(cfg, cell) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference), N = active params."""
    n = cfg.active_params()
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * cell.global_batch  # decode: one token per row


def _fake_group(world: int) -> None:
    """Start the fake process group of ``world`` ranks as rank 0; refuse
    if a real group is up."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import fake_group_is_up
    if dist.is_initialized():
        if not fake_group_is_up():
            raise RuntimeError(f"the dry run refuses to start: a real process group "
                               f"({dist.get_backend()}) is up")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _cell_of(arch: str, cell_name: str, smoke: bool, depth: int):
    from repro_torch.configs import at_depth, get_cell, get_config, get_smoke_config
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    cell = get_cell(cell_name)
    if smoke:  # reduced shapes, same kind — plumbing validation only
        cell = dataclasses.replace(cell, seq_len=256 if cell.kind != "decode" else 512,
                                   global_batch=32)
    if depth:
        cfg = at_depth(cfg, depth)
    return cfg, cell


def build_cell(cfg, cell, ctx):
    """(step, its stored arguments) of a cell on ``ctx``'s mesh, on the
    meta device."""
    from repro_torch.configs import input_specs
    from repro_torch.distributed.sharding import param_specs, place, stored_zeros
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M
    mesh = ctx.mesh
    batch, bshard = S.train_inputs(cfg, ctx, cell, input_specs(cfg, cell))
    batch = place(batch, bshard, mesh)
    if cell.kind == "train":
        fn, (pspec, ospec), _ = S.make_train_step(cfg, ctx, cell)
        aparams, aopt = S.abstract_train_state(cfg)
        return fn, (place(aparams, pspec, mesh), place(aopt, ospec, mesh), batch)
    params = place(M.abstract_params(cfg), param_specs(cfg, ctx), mesh)
    if cell.kind == "prefill":
        fn, _, _ = S.make_prefill_step(cfg, ctx, cell)
        return fn, (params, batch)
    fn, cspecs, _ = S.make_decode_step(cfg, ctx, cell)
    total_seq = cell.seq_len + (cfg.vision_prefix_len if cfg.family == "vlm" else 0)
    cache = stored_zeros(M.cache_shapes(cfg, cell.global_batch, total_seq), cspecs, mesh,
                         cfg.adtype, "meta")
    return fn, (params, cache, batch)


def argument_bytes(args, read=None) -> tuple:
    """(bytes of the arguments, [(path, bytes) of those no operator read]).
    With ``read`` (ids of the tensors the step's operators took), the
    bytes count the arguments read only, as ``jax.jit`` prunes unused
    arguments from the compiled program."""
    from repro_torch.distributed.sharding import local_of
    from repro_torch.tree import flatten_with_paths
    total, unread = 0, []
    for path, leaf in flatten_with_paths(list(args)):
        t = local_of(leaf)
        if not isinstance(t, torch.Tensor):
            continue
        n = t.numel() * t.element_size()
        if read is not None and id(t) not in read:
            unread.append((path, n))
        else:
            total += n
    return total, unread


def output_bytes(outs) -> int:
    """The outputs' local bytes plus XLA's output tuple: one 8-byte pointer
    a leaf."""
    from repro_torch.distributed.sharding import local_bytes
    from repro_torch.tree import leaves
    n = len(leaves(list(outs)))
    return local_bytes(list(outs)) + (8 * n if n > 1 else 0)


def run_cell(arch: str, cell_name: str, multi_pod: bool, out_dir: Path,
             overrides: dict | None = None, smoke: bool = False,
             depth: int = 0, batch_whole: bool = False) -> dict:
    import torch.distributed as dist
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import local_of
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.tree import leaves

    t0 = time.time()
    overrides = dict(overrides or {})
    tag = overrides.pop("tag", None)
    cfg, cell = _cell_of(arch, cell_name, smoke, depth)
    n_dev = 512 if multi_pod else 256
    _fake_group(n_dev)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        ctx = S.make_ctx(mesh, **overrides, **({"batch_axes": ()} if batch_whole else {}))
        fn, args = build_cell(cfg, cell, ctx)
        t_build = time.time() - t0
        mem = MemTracker()
        mem.track_external(*(t for t in map(local_of, leaves(list(args)))
                             if isinstance(t, torch.Tensor)))
        coll = CollectiveBytes()
        op_bytes = _op_bytes_mode()
        with FlopCounterMode(display=False) as flops, mem, coll, op_bytes:
            outs = fn(*args)
        arg_bytes, unread = argument_bytes(args, op_bytes.seen)
        peak = int(mem.get_tracker_snapshot("peak")[torch.device("meta")]["Total"])
        out_bytes = output_bytes(outs)
        t_run = time.time() - t0 - t_build
    finally:
        dist.destroy_process_group()

    flops_dev = float(flops.get_total_flops())
    bytes_dev = float(op_bytes.total)
    collectives = coll.record()
    mf = model_flops(cfg, cell)
    terms = {
        "compute_s": flops_dev / PEAK_FLOPS,
        "memory_s": bytes_dev / HBM_BW,
        "collective_s": collectives["total"] / LINK_BW,
    }
    dominant = max(terms, key=terms.get)
    rec = {
        "arch": arch, "cell": cell_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "depth": depth or cfg.num_layers,
        "full_depth": get_config(arch).num_layers if not smoke else cfg.num_layers,
        "n_devices": n_dev,
        "flops_per_dev": flops_dev,
        "op_bytes_per_dev": bytes_dev,
        "collective_bytes_per_dev": collectives["total"],
        "collectives": {k: v for k, v in collectives.items() if k != "total"},
        "roofline": terms,
        "dominant": dominant,
        "model_flops_global": mf,
        "useful_flops_ratio": mf / max(flops_dev * n_dev, 1.0),
        "memory_analysis": {"argument_size_in_bytes": arg_bytes,
                            "output_size_in_bytes": out_bytes,
                            "peak_size_in_bytes": peak},
        "unread_arguments": dict(unread),
        "build_s": round(t_build, 2), "run_s": round(t_run, 2),
        "overrides": overrides,
        "batch_whole": batch_whole,
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    ov = dict(overrides)
    if tag:
        ov["tag"] = tag
    suffix = "_".join(f"{k}-{v}" for k, v in ov.items())
    fname = f"{arch}__{cell_name}__{rec['mesh']}"
    if depth:
        fname += f"__depth{depth}"
    if suffix:
        fname += f"__{suffix}"
    if batch_whole:
        fname += "__batch-whole"
    (out_dir / f"{fname}.json").write_text(json.dumps(rec, indent=1))
    print(f"[dryrun] {arch} {cell_name} mesh={rec['mesh']} "
          f"run={t_run:.1f}s dominant={dominant} "
          f"terms(ms)=({terms['compute_s']*1e3:.2f}, {terms['memory_s']*1e3:.2f}, "
          f"{terms['collective_s']*1e3:.2f}) useful={rec['useful_flops_ratio']:.3f}")
    print("  memory:", rec["memory_analysis"])
    return rec


# =============================================================================
# orchestrator
# =============================================================================

def _all_cells():
    from repro_torch.configs import ASSIGNED_ARCHS, dryrun_cells
    for arch in ASSIGNED_ARCHS:
        for cell in dryrun_cells(arch):
            yield arch, cell.name


def run_all(jobs: int, multi_pod_mode: str, out_dir: Path,
            with_depth_probes: bool = True) -> int:
    """Every (arch, cell) in a process of its own: the requested mesh(es)
    at full depth, and the reference's two reduced-depth probes on the
    single-pod mesh."""
    from repro_torch.configs import depth_pair, get_config
    cells = list(_all_cells())
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[multi_pod_mode]
    work = []  # (arch, cell, multi_pod, depth)
    for a, c in cells:
        for mp in meshes:
            work.append((a, c, mp, 0))
        if with_depth_probes:
            for d in depth_pair(get_config(a)):
                work.append((a, c, False, d))
    pending = []
    for a, c, mp, d in work:
        mesh = "2x16x16" if mp else "16x16"
        fname = f"{a}__{c}__{mesh}" + (f"__depth{d}" if d else "")
        if not (out_dir / f"{fname}.json").exists():
            pending.append((a, c, mp, d))
    print(f"[dryrun] {len(pending)}/{len(work)} cells pending")
    procs: list = []
    failed = []
    idx = 0
    while idx < len(pending) or procs:
        while idx < len(pending) and len(procs) < jobs:
            a, c, mp, d = pending[idx]
            idx += 1
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", a, "--cell", c, "--out", str(out_dir)] \
                + (["--multi-pod"] if mp else []) + (["--depth", str(d)] if d else [])
            mesh = "2x16x16" if mp else "16x16"
            log = out_dir / (f"{a}__{c}__{mesh}" + (f"__depth{d}" if d else "") + ".log")
            out_dir.mkdir(parents=True, exist_ok=True)
            procs.append((subprocess.Popen(cmd, stdout=log.open("w"),
                                           stderr=subprocess.STDOUT), a, c, mp, d))
        time.sleep(0.5)
        still = []
        for p, a, c, mp, d in procs:
            if p.poll() is None:
                still.append((p, a, c, mp, d))
            elif p.returncode != 0:
                failed.append((a, c, mp, d, p.returncode))
                print(f"[dryrun] FAIL {a} {c} multi_pod={mp} depth={d} rc={p.returncode}",
                      flush=True)
            else:
                print(f"[dryrun] done {a} {c} multi_pod={mp} depth={d}", flush=True)
        procs = still
    if failed:
        print(f"[dryrun] {len(failed)} FAILURES: {failed}")
        return 1
    print("[dryrun] sweep complete")
    return 0


def table(out_dir: Path) -> str:
    """A markdown table of the full-depth records in ``out_dir``, one row
    an (arch, cell), each column "16x16 / 2x16x16"."""
    recs: Dict[tuple, dict] = {}
    for f in sorted(out_dir.glob("*.json")):
        rec = json.loads(f.read_text())
        if (rec["depth"] == rec["full_depth"] and not rec["overrides"]
                and not rec.get("batch_whole")):
            recs.setdefault((rec["arch"], rec["cell"]), {})[rec["mesh"]] = rec

    def both(row: dict, get) -> str:
        return " / ".join(str(get(row[m])) if m in row else "-" for m in ("16x16", "2x16x16"))

    rows = ["| arch | cell | argument B | peak B | collective wire B |",
            "| --- | --- | --- | --- | --- |"]
    for (arch, cell), row in sorted(recs.items()):
        rows.append(
            f"| {arch} | {cell} | "
            f"{both(row, lambda r: r['memory_analysis']['argument_size_in_bytes'])} | "
            f"{both(row, lambda r: r['memory_analysis']['peak_size_in_bytes'])} | "
            f"{both(row, lambda r: round(r['collective_bytes_per_dev']))} |")
    return "\n".join(rows)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--cell")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--meshes", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=str(ARTIFACT_DIR))
    ap.add_argument("--override", action="append", default=[],
                    help="ShardCtx overrides, e.g. --override mla_absorb=true")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + shapes (plumbing validation)")
    ap.add_argument("--depth", type=int, default=0,
                    help="reduced depth (the reference's roofline probes)")
    ap.add_argument("--batch-whole", action="store_true",
                    help="no batch axes: every rank holds and computes the whole batch")
    ap.add_argument("--table", action="store_true",
                    help="print the full-depth records under --out as a markdown table")
    args = ap.parse_args()
    out_dir = Path(args.out)
    if args.table:
        print(table(out_dir))
        return 0
    if args.all:
        return run_all(args.jobs, args.meshes, out_dir)
    overrides = {}
    for ov in args.override:
        k, _, v = ov.partition("=")
        if v.lower() in ("true", "false"):
            overrides[k] = v.lower() == "true"
        else:
            try:
                overrides[k] = int(v)
            except ValueError:
                overrides[k] = v
    run_cell(args.arch, args.cell, args.multi_pod, out_dir, overrides,
             smoke=args.smoke, depth=args.depth, batch_whole=args.batch_whole)
    return 0


if __name__ == "__main__":
    sys.exit(main())
