#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. Builds the four CUDA sources of the port (five kernels) from
   src/repro_torch/kernels/csrc/ with nvcc (one process per source, in
   parallel) and prints the build seconds and the compiler's register /
   shared-memory report.
2. Holds each kernel against its plain PyTorch version on the card at the
   paths' full qwen3-30b-a3b shapes, shows that each gate would catch the
   faults it is there for (tiles and chunks dropped or unmasked at the
   kernels' own sizes; for both flash-decodes, merges that drop a partial
   or skip the rescale; for the paged one, chunks that read the wrong page
   or, on int8 pages, the wrong scales), checks the paged flash-decode at a
   second page size (48) too, and times kernel, plain version and
   (where one PyTorch call computes the same function) that call, with
   CUDA events: median of 20 launches, L2 flushed before each.  Each
   kernel line gives the achieved TB/s of the bytes its bound counts.
   The router (kernels 2 and 5, one launch over a thread-block cluster)
   is checked at T = 1, 8, 512, 1024 and 5000 and at two forced launch
   plans (several CTAs, several rounds), with identity and replica tables
   and random, tied and skewed logits; four wrong counts are shown to fall
   outside its gate, the profiler shows one launch a call, and one call
   is captured in a CUDA graph and replayed.  Both decode kernels are
   checked and timed the same way at the dense families' shapes too:
   gemma2-2b's 8 / 4 heads x 256 with softcap 50 over 4864 positions (and
   int8 pages), granite-20b's 48 query heads on one KV head, and kernel 4
   at llama4's 40 / 8 heads x 128 and zamba2's 32 / 32 heads x 64.
   Before any model is resident, the router is checked the same way at
   deepseek-v2's E = 160, k = 6 and llama4's E = 128, k = 1 (identity and
   replica tables, kernel 5; T = 8, 512 and a forced plan), and
   ``moe_gemm`` in bf16 at deepseek's (160, C, 5120) x (160, 5120, 1536)
   and (160, C, 1536) x (160, 1536, 5120) and llama4's (128, C, 5120) x
   (128, 5120, 8192) and (128, C, 8192) x (128, 8192, 5120), C = 8 and 32.
3. Checks the kernel path against the plain path end to end at full width
   in f32 (2 layers): one paged decode step, and one slot-layout decode
   step under a replicated placement whose weights ``apply_placement``
   gathered.
4. Serves requests through ``Engine`` at full qwen3-30b-a3b width (bf16,
   depth cut to 4 layers: 48 layers are ~61 GB of weights; depth changes no
   kernel shape): on the paged KV layout with the fused MoE path and no
   expert level (plus a shorter int8-KV run and a traced run), then on the
   slot layout with the "gimbal+rep" expert level, which rebalances and
   replicates experts mid-run (plus a shorter traced run).  Every request must finish, all logits must
   be finite, each kernel's launch count must match the path, the paged
   runs must share prefix pages and drain the pool, and the slot run must
   relocate experts into a replicated slot map that the router kernel
   receives.  During the slot run the slot flash-decode kernel and the
   identity router kernel are held against their plain versions on the
   run's own cache and router logits.  The traced runs must show one
   router kernel name per instantiation, launched once per wrapper call.
5. Serves a ShareGPT-style multi-user trace (24 turns of 6 users, 8
   requests a second) through the port's ``Cluster`` of such engines on the
   logical clock (``run_drill``, dt 0.05), on the same weights: C1, two
   paged engines behind "combined" dispatch under the "kill_migrate"
   fault drill; C2, one prefill and one decode engine handing KV off (12
   requests); C3, two slot-layout engines sharing one "gimbal+rep" expert
   level seeded with the synthetic prior (16 requests), run twice from
   fresh state.  Every request must finish or be shed with finite logits,
   each engine's kernel launches must equal its prefill and decode calls'
   path, C1 must fail over, re-route, restore, hit shared prefixes and
   drain its pages, C2 must hand every request off once and finish it on
   the decode engine, C3 must rebalance into 132-slot tables that every
   engine applies, and C3's two runs must give identical greedy tokens,
   observed expert ids and rebalance events.  Each run prints its wall
   seconds, cluster steps, wall ms per step, generated tokens per wall
   second and per-engine request counts.
6. Serves the dense GQA families at full width, random weights from seed
   0, each model freed before the next: gemma2-2b at full depth (26
   layers; first one f32 decode step of 2 layers, kernels against the
   plain path), 8 requests, then 2 prompts of 4200-4400 tokens past its
   4096-token window, then a short traced run (the device's busy share
   and the host's waits on it); qwen2-72b (QKV bias), granite-20b (MQA) and
   granite-3-8b, each cut to 4 layers, 8 requests each; internvl2-26b's
   language model at 4 layers, prefilled with a 256-position vision prefix
   and decoded 8 steps on the slot layout, where kernel 4 is held against
   its plain version on the run's own cache.  Every request must finish
   with finite logits, kernel 1 must launch once per global layer a paged
   decode step (gemma2's windowed local layers attend in plain PyTorch),
   and the paged runs must share prefix pages and drain the pool.  Each run
   prints wall seconds, ms a decode step, generated tokens a second and
   peak device memory.
7. Serves the MoE variants and runs the encoder-decoder at full width,
   random bf16 weights from seed 0, each model freed before the next:
   deepseek-v2 (MLA, a dense prologue layer, 2 shared experts, top-6 of
   160; first one f32 decode step of 2 layers under a replicated
   placement, kernels against the plain path and MLA's absorbed decode
   against the naive one), then 16 requests at 4 layers through ``Engine``
   on the slot layout under "gimbal+rep", which must rebalance into a
   replicated map (S = 164) that the router kernel receives; llama4 at 2
   layers (interleaved top-1 MoE with a shared expert; one bf16 decode
   step, kernels against the plain path), then 16 requests under "vllm"
   (no relocation) with kernel 4 held against its plain version on the
   run's slot cache; a short traced run of each gives moe_gemm's share of
   device time.  Each engine run counts the slots no row reached at
   T = 8.  whisper-medium at full depth (24 + 24 layers): seeded (8, 1500,
   1024) frames, prompts of 16-64 tokens, ``prefill`` then 32
   ``decode_step``s, logits finite.  Launch counts must match the path.
8. Serves the SSM and hybrid families at full width and full depth,
   random bf16 weights from seed 0: first two f32 gates at shallow depth
   (mamba2 at 2 layers, zamba2 at 3: one super-block and one epilogue
   layer), the card against the CPU on the same weights (a 300-token
   prefill of two chunks and 4 decode steps) and each recurrent decode
   step against an unpadded chunked prefill at that position, which must
   reject two faulty decodes (the state not written back, the conv tail
   read as zeros); then mamba2-370m (48 layers) and zamba2-1.2b (38) each
   through ``Engine`` on the slot layout (16 requests, the state in bf16,
   ``usage()`` state-slot occupancy for mamba2 and resident tokens for
   zamba2), a 16383-token mamba2 row whose engine's slot cache must be no
   larger than the 1024-position engine's, a short traced mamba2 run (busy
   share, host waits a decode step), and kernel 4 held against its plain
   version on zamba2's shared-attention cache during the run and timed on
   it beside SDPA.  Launch counts must match the path.
9. Trains through ``repro_torch.launch`` (AdamW with f32 moments,
   warm-up 10, clip 1.0, ``TokenStream(seed=0)`` data): T0, one f32 train
   step of the smoke qwen3 and mamba2 configs on the card against the CPU
   (loss, grad norm, every param and moment within 2e-4), which must reject
   three faulty CPU steps (weight decay on vectors, no bias correction, the
   router aux loss dropped); T1, qwen3-30b-a3b at full width cut to 4
   layers, bf16, 8 x 128 tokens, dense dispatch: 8 timed steps on the
   stream (ms a step split into forward + backward and optimizer, trained
   tokens/s, peak memory), then 8 on one batch, where the loss must fall by
   0.1 and two steps at lr 0 must not, and one traced step; T2,
   mamba2-370m at full depth, bf16, 8 x 512 tokens with remat: 4 timed
   steps with a checkpoint after step 2, restored into fresh tensors and
   run on, bit-identical to the uninterrupted run (a checkpoint without its
   manifest is ignored, a leaf of the wrong shape refused), and remat on
   and off at batch 2 with the same loss and grad norm; T3, ``python -m
   repro_torch.launch.train`` run for 6 steps and rerun to 10 in a
   subprocess, which must resume from step 6 and end where an
   uninterrupted run ends (both through ``launch.train``'s context, as
   every ``train()`` runs); T1c, T1's model, shape and data through
   ``launch.train``'s context path (``make_mesh`` (1, 1), ``make_ctx``,
   the expert-parallel MoE): timed steps beside T1's, losses within the
   bf16 tolerance of T1's, the peak memory of one forward + backward
   with remat off and under each ``remat_policy`` ("none", "dots",
   "full"), and on the smoke qwen3 in f32 the gradients of "dots" and
   "full" within 2e-4 of "none", which must reject a "dots" step whose
   gates' gradient is cut.  Training must launch none of the kernels.
10. Runs the sharding layer's context on one card, before the train
   phase: ``launch.mesh.make_mesh`` starts a single-rank NCCL group over a
   FileStore, and a psum on the card must return its input.  qwen3-30b-a3b
   (4 layers, bf16, 8 rows x 128 tokens, 16 decode steps) through
   ``make_prefill_step`` / ``make_decode_step`` with the (1, 1) mesh's
   context and with ``ctx=None``, each path twice: tokens identical across
   the runs; one teacher-forced decode step's logits within the bf16
   tolerance on every row that both paths routed to the same experts;
   each MoE layer's input routed by ``moe_apply_sharded`` as by
   ``moe_apply``; the collectives a decode step counted by kind, every
   layer computing on its "model" blocks (on one rank the whole tensors,
   every collective still run): a teacher-forced step's all-reduces must
   be one for the embedding, four a layer (``wo`` and the flash-decode
   combine) and two a MoE layer, which must reject a step whose ``wo``
   output skips its reduce; the bf16 token
   agreement of the two paths printed (the reference's sequence-sharded
   decode rounds otherwise than the plain one), then the ctx path run
   again with the plain path's attention decode, its MoE, and both
   swapped in: with the plain attention decode, tokens identical to the
   plain path's, which must reject a MoE combine without gates.  First
   the same at 2 layers in f32: tokens identical and logits within 2e-4,
   which must reject a decode that skips its chunk's row write and a MoE
   combine without gates.
   deepseek-v2 (4 layers) the same way with MLA absorbed against naive,
   both under the context.  None of these launches a kernel.
11. Runs ``python -m repro_torch.launch.serve`` as a user would (the
   reference's defaults: qwen3's smoke config, "gimbal", 2 engines,
   BurstGPT --n 40) in a subprocess on the card, plain and with
   ``--fail-engine 1``: every request must finish and the failure must
   re-route requests; prints its report lines and wall seconds.  Then
   runs ``python -m repro_torch.launch.dryrun`` in subprocesses, all at
   once: five cells at full depth on the production meshes, and qwen3's
   train_4k and decode_32k at depth 4 on 16 x 16 with the batch in blocks
   over "data" (each rank computes its rows) and with ``--batch-whole``:
   each must exit 0, and each pair's FLOPs a rank must fall at least 8x
   with the batch in blocks (7x in decode_32k, where the experts' capacity
   of at least 8 rows a slot halves only); qwen3 train_4k's at depth 4 must
   be at least 4x below its 2.3905e14 with every layer whole over "model".  T1c and
   the ctx phase's decode steps run with their batch stored in blocks and
   their layers on their "model" blocks, so each prints its collectives a
   step by kind, and the paged engine runs print the pool's ``usage()`` and
   ``kv_bytes_used()`` after the drain, which must be 0.
12. Prints the card's name and power limit, one JSON line listing the
   kernels (with the cluster, families, variants, ssm, ctx and train
   runs' launches beside the main path's), and as the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when there is no CUDA device or the
port's sources are missing.  Imports nothing of JAX or of the reference
package.
"""
from __future__ import annotations

import contextlib
import copy
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
ARCH = "qwen3-30b-a3b"
SEED = 0
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (NVIDIA data sheet)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense bf16 tensor / f32 non-tensor
TOL = {"bfloat16": 5e-2, "float32": 2e-4}
# (rtol, atol) of flash_decode_paged against its plain version: both compute
# in f32 and round the output to q's dtype once, so a bf16 output may differ
# by one rounding step (< 1 % of the value)
FD_TOL = {"bfloat16": (1e-2, 1e-3), "float32": (2e-4, 2e-4)}
# (rtol, atol as a fraction of the plain output's rms) of moe_gemm: both
# sides accumulate in f32 and round once, so a bf16 output may differ by one
# rounding step (< 0.8 % of the value); atol covers values near zero
MG_TOL = {"bfloat16": (1e-2, 1e-3), "float32": (2e-4, 2e-4)}
PROFILE_ATTEMPTS = 5     # traces Timer.device_rows takes before it trusts an empty one


def log(*a) -> None:
    print(*a, flush=True)


# ----------------------------------------------------------------------------- timing

class Timer:
    """CUDA-event timing of one launch at a time, median over ``iters``,
    with a 256 MB buffer rewritten before each launch so that no input is
    left in the 50 MB L2 by the previous launch."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=DEVICE)

    def ms(self, fn, iters: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(iters):
            self.flush.zero_()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            out.append(s.elapsed_time(e))
        return statistics.median(out)

    def device_rows(self, fn, iters: int = 20) -> list:
        """(kernel name, device us per call, launches) of each kernel ``fn``
        launches, from torch.profiler over ``iters`` calls with the L2
        flushed before each (the flush's own kernel left out).  A trace
        that holds no device event at all, not even the flushes', is taken
        again after a pause of 1, 2, 4, ... s, up to PROFILE_ATTEMPTS
        traces: on the card the profiler now and then hands back empty
        traces for a while, which says nothing about ``fn``'s kernels (a
        trace that shows the flushes is never retaken)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        for attempt in range(1, PROFILE_ATTEMPTS + 1):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    self.flush.zero_()
                    fn()
                torch.cuda.synchronize()
            events = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
            if events or attempt == PROFILE_ATTEMPTS:
                break
            log(f"profiler: a trace of {iters} calls holds no device event, not even the "
                f"L2 flushes'; tracing again in {2 ** (attempt - 1)} s "
                f"({attempt}/{PROFILE_ATTEMPTS})")
            time.sleep(2 ** (attempt - 1))
        rows = []
        for ev in events:
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0.0)
            if us > 0 and "FillFunctor" not in ev.key:
                rows.append((ev.key, us / iters, ev.count))
        return rows

    def device_us(self, fn, iters: int = 20) -> str:
        """Device time per call of each kernel ``fn`` launches: where a
        call's time goes."""
        rows = [f"{key.rsplit('(', 1)[0][-48:]} {us:.2f} us"
                for key, us, _ in self.device_rows(fn, iters)]
        return "; ".join(rows) or "no device time recorded"

    def host_us(self, fn, iters: int = 200) -> float:
        """Host microseconds a call of ``fn`` takes to enqueue its work: the
        median of ``iters`` calls on the host clock, with no synchronize
        between them (the median, because the host's other work lands on a
        few calls)."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(iters):
            t = time.perf_counter()
            fn()
            out.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        return statistics.median(out) * 1e6


class EmptyTrace(AssertionError):
    """A traced run's profiler trace held no device event at all."""


def _retraced(run):
    """``run(trace=True)``, run again after a pause of 1, 2, 4, ... s while
    its trace holds no device event at all (``EmptyTrace``), up to
    PROFILE_ATTEMPTS runs, as ``Timer.device_rows`` retakes a trace.
    ``run`` builds its engine and requests anew on each call."""
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        try:
            return run(trace=True)
        except EmptyTrace as exc:
            if attempt == PROFILE_ATTEMPTS:
                raise
            log(f"{exc}; running it again in {2 ** (attempt - 1)} s "
                f"({attempt}/{PROFILE_ATTEMPTS})")
            time.sleep(2 ** (attempt - 1))


def max_excess(got, want, rtol: float, atol: float) -> tuple:
    """(max |got - want|, max of |got - want| - rtol * |want| - atol): the
    second is <= 0 when every element is within allclose(rtol, atol)."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    return float(d.max()), float((d - rtol * w.abs() - atol).max())


def check_close(name: str, got, want, rtol: float, atol: float | None = None) -> float:
    atol = rtol if atol is None else atol
    finite = bool(got.float().isfinite().all())
    err, excess = max_excess(got, want, rtol, atol)
    if not finite or excess > 0:
        raise AssertionError(f"{name}: kernel disagrees with plain version "
                             f"(max abs err {err:.3e}, rtol {rtol}, atol {atol}, "
                             f"finite={finite})")
    return err


# ----------------------------------------------------------------------------- kernels

def kernel_phase(torch, timer: Timer, cfg) -> dict:
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    dev = DEVICE
    results = {}

    def randn(*shape, dtype=torch.float32, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    results.update(_paged_flash_decode_checks(torch, timer, cfg, gen))

    router = _router_checks(torch, timer, cfg, gen)
    results["topk_router_replicated"] = router["topk_router_replicated"]

    # --- grouped GEMM: C = 8 (decode, T = 8) and 48 (512-token bucket) ----------
    e, dm, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    mg = {}
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        w_up = randn(e, dm, f, dtype=dtype, std=dm ** -0.5)
        w_down = randn(e, f, dm, dtype=dtype, std=f ** -0.5)
        for c in (8, 48):
            for proj, w, din in (("gate/up", w_up, dm), ("down", w_down, f)):
                x = randn(e, c, din, dtype=dtype)
                mg[(dtype_name, c, proj)] = _moe_gemm_case(
                    torch, timer, x, w, dtype_name, f"C={c} {proj}")
        del w_up, w_down
    main = mg[("bfloat16", 8, "gate/up")]
    results["moe_gemm"] = dict(
        source="src/repro_torch/kernels/csrc/moe_gemm.cu",
        replaces="src/repro/kernels/moe_gemm.py:33",
        max_abs_err=max(v["err"] for v in mg.values()), ms=main["ms"],
        plain_ms=main["plain"], bound_ms=main["bound"][0], bound_by=main["bound"][1],
        library_ms=main["lib"])
    results.update(_slot_flash_decode_checks(torch, timer, cfg, gen))
    results["topk_router"] = router["topk_router"]
    for name, err in _family_decode_checks(torch, timer, gen).items():
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
    for name, err in _variant_kernel_checks(torch, timer, gen).items():
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
    return results


def _moe_gemm_case(torch, timer: Timer, x, w, dtype_name: str, label: str) -> dict:
    """``moe_gemm(x, w)`` against its plain version under the rms-relative
    gate, with the gate shown to reject a kernel that skipped its last K
    tile or zeroed one F tile's edge at this dtype's tiles (bf16: 64 deep x
    128 wide; f32: 32 x 64); timed beside the plain version and
    ``torch.bmm`` (and, in bf16, their device time).  Returns err, ms,
    plain, lib and bound."""
    from repro_torch.kernels import moe_gemm, ref
    from repro_torch.kernels.moe_gemm import launch_plan

    e, c, din = x.shape
    dout = w.shape[2]
    got = moe_gemm(x, w)
    want = ref.ref_moe_gemm(x, w)
    torch.cuda.synchronize()
    name = f"moe_gemm[{dtype_name},{label}]"
    rtol, atol_frac = MG_TOL[dtype_name]
    atol = atol_frac * float(want.float().square().mean().sqrt())
    err = check_close(name, got, want, rtol, atol)
    del got
    plan = launch_plan(e, c, din, dout, x.dtype)
    bk, bf = plan.block_k, plan.block_f
    wrong = {f"last {bk}-deep K tile dropped": lambda: ref.ref_moe_gemm(x[..., :-bk],
                                                                       w[:, :-bk]),
             f"last {bf}-wide F tile zeroed": lambda: torch.cat(
                 [want[..., :-bf], torch.zeros_like(want[..., -bf:])], -1)}
    for fault, bad in wrong.items():
        if max_excess(bad(), want, rtol, atol)[1] <= 0:
            raise AssertionError(f"{name}: the tolerance cannot tell {fault!r} "
                                 f"from the plain version")
    del want
    ms = timer.ms(lambda: moe_gemm(x, w))
    plain = timer.ms(lambda: ref.ref_moe_gemm(x, w))
    lib = timer.ms(lambda: torch.bmm(x, w))
    if dtype_name == "bfloat16":
        log(f"device time moe_gemm {label}: kernel "
            f"[{timer.device_us(lambda: moe_gemm(x, w))}] torch.bmm "
            f"[{timer.device_us(lambda: torch.bmm(x, w))}]")
    item = x.element_size()
    nbytes = (x.numel() + w.numel() + e * c * dout) * item
    bound = _bound(nbytes, 2 * e * c * din * dout, dtype_name)
    log(f"kernel moe_gemm dtype={dtype_name} {label} "
        f"({e}x{c}x{din} @ {e}x{din}x{dout}; block C {plan.block_c}, grid "
        f"{plan.grid}, smem {plan.smem} B): max_abs_err={err:.3e} "
        f"(rtol {rtol}, atol {atol:.3e}) ms={ms:.4f} plain_ms={plain:.4f} "
        f"library_ms(torch.bmm)={lib:.4f} bound_ms={bound[0]:.4f} ({bound[1]}) "
        f"{_tb_s(nbytes, ms)} bmm_{_tb_s(nbytes, lib)}")
    return dict(err=err, ms=ms, plain=plain, lib=lib, bound=bound)


def _paged_pool(torch, gen, b: int, nb: int, bs: int, hkv: int, d: int):
    """A bf16 page pool of b * nb pages plus the garbage page 0, its int8
    quantisation with per-page scales (quantize_int8, as PagedKVCache
    stores it), and scattered block tables that never name page 0."""
    from repro_torch.training.compression import quantize_int8

    pool = b * nb + 1
    kp = torch.randn((pool, bs, hkv, d), generator=gen, device=DEVICE).to(torch.bfloat16)
    vp = torch.randn((pool, bs, hkv, d), generator=gen, device=DEVICE).to(torch.bfloat16)
    perm = torch.randperm(pool - 1, generator=gen, device=DEVICE)[:b * nb] + 1
    tables = perm.reshape(b, nb).to(torch.int32)
    kq, ksc = torch.vmap(quantize_int8)(kp.reshape(pool, -1))
    vq, vsc = torch.vmap(quantize_int8)(vp.reshape(pool, -1))
    return kp, vp, kq.reshape(kp.shape), vq.reshape(vp.shape), ksc, vsc, tables


def _paged_flash_decode_checks(torch, timer: Timer, cfg, gen) -> dict:
    """Kernel 1 at the paged path's shape (B = max_slots = 8, NB = max_seq /
    16 = 64 pages of 16 positions, 32 / 4 heads x 128) for the four (q,
    page) dtype pairs the path makes, softcap 0 and 30, with the fault
    checks its gate must see and its times; then at 48-position pages (22
    a row), which straddle the 32-position chunks and are no power of two,
    to show that the block-table map is not tied to 16."""
    from repro_torch.kernels import flash_decode_paged, ref
    from repro_torch.kernels.flash_decode import split_plan

    b, hq, hkv, d = 8, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = torch.randn((b, hq, d), generator=gen, device=DEVICE).to(torch.bfloat16)
    fd = {}
    for bs, nb in ((16, 64), (48, 22)):
        path = bs == 16
        kp, vp, kq, vq, ksc, vsc, tables = _paged_pool(torch, gen, b, nb, bs, hkv, d)
        if path:
            lengths = torch.randint(1, nb * bs + 1, (b,), generator=gen, device=DEVICE)
            lengths[3] = 0
        else:
            lengths = torch.tensor([nb * bs, 0, 1, bs + 1, 33, 511, 700, 1000], device=DEVICE)
        lengths = lengths.to(torch.int32)
        n_tok = int(lengths.sum())
        span = split_plan(b, nb * bs, hq, hkv, d, 2).span
        for pages, (kk, vv, ks, vs) in (("bf16", (kp, vp, None, None)),
                                        ("int8", (kq, vq, ksc, vsc)),
                                        ("f32", (kp.float(), vp.float(), None, None)),
                                        ("int8/f32 q", (kq, vq, ksc, vsc))):
            qq = q.float() if pages in ("f32", "int8/f32 q") else q
            rtol, atol = FD_TOL[str(qq.dtype).removeprefix("torch.")]
            for softcap in (0.0, 30.0):
                # softcap cases scale q so that the scores reach where the
                # cap bends them, as the CPU test does
                args = (qq * 10 if softcap else qq, kk, vv, tables, lengths)
                kw = dict(k_scale=ks, v_scale=vs, softcap=softcap)
                name = f"flash_decode_paged[BS={bs},{pages},softcap={softcap}]"
                got = flash_decode_paged(*args, **kw)
                want = ref.ref_flash_decode_paged(*args, **kw)
                torch.cuda.synchronize()
                err = check_close(name, got, want, rtol, atol)
                if not (got[lengths == 0] == 0).all():
                    raise AssertionError(f"{name}: length-0 row is not exactly zero")
                fd[(bs, pages, softcap)] = row = dict(err=err)
                line = (f"kernel flash_decode_paged BS={bs} NB={nb} pages={pages} "
                        f"softcap={softcap} tokens={n_tok}: max_abs_err={err:.3e} "
                        f"(rtol {rtol}, atol {atol})")
                if not path:
                    log(line)
                    continue
                # the gate must be tight enough to see the faults it is there for
                wrong = _paged_faults(torch, ref, args, kw, span)
                if softcap:
                    wrong["no softcap"] = ref.ref_flash_decode_paged(
                        *args, **{**kw, "softcap": 0.0})
                if ks is not None:
                    wrong["stale page scale"] = ref.ref_flash_decode_paged(
                        *args, **{**kw, "k_scale": ks.roll(1), "v_scale": vs.roll(1)})
                for fault, bad in wrong.items():
                    if max_excess(bad, want, rtol, atol)[1] <= 0:
                        raise AssertionError(f"{name}: the tolerance cannot tell "
                                             f"{fault!r} from the plain version")
                line += f" faults_outside_gate={len(wrong)}"
                if pages not in ("bf16", "int8"):
                    log(line)
                    continue
                row["ms"] = timer.ms(lambda: flash_decode_paged(*args, **kw))
                row["plain"] = timer.ms(lambda: ref.ref_flash_decode_paged(*args, **kw))
                if not softcap:
                    log(f"device time flash_decode_paged pages={pages}: kernel "
                        f"[{timer.device_us(lambda: flash_decode_paged(*args, **kw))}]")
                kv_item = 1 if pages == "int8" else 2
                n_pages = int(((lengths + bs - 1) // bs).sum())
                nbytes = (2 * q.numel() * 2 + n_tok * hkv * d * 2 * kv_item
                          + tables.numel() * 4 + b * 4 + (2 * 4 * n_pages if ks is not None else 0))
                row["bound"] = _bound(nbytes, 4 * n_tok * hq * d, "bfloat16")
                log(f"{line} ms={row['ms']:.4f} plain_ms={row['plain']:.4f} library_ms=none "
                    f"bound_ms={row['bound'][0]:.4f} ({row['bound'][1]}) "
                    f"{_tb_s(nbytes, row['ms'])}")
    main = fd[(16, "bf16", 0.0)]
    return {"flash_decode_paged": dict(
        source="src/repro_torch/kernels/csrc/flash_decode_paged.cu",
        replaces="src/repro/kernels/flash_decode.py:157",
        max_abs_err=max(v["err"] for v in fd.values()), ms=main["ms"],
        plain_ms=main["plain"], bound_ms=main["bound"][0], bound_by=main["bound"][1],
        library_ms=None)}


def _paged_faults(torch, ref, args, kw, span: int) -> dict:
    """Wrong answers a paged split kernel could give, each computed by the
    plain versions on the same inputs: no length mask inside the last page
    or the last chunk;
    the merge dropping each row's last partial or skipping the rescale; a
    chunk reading its later pages as the physical pages after its first's;
    and for int8 pages, one scale pair for a whole chunk (its first page's)
    or the V scale inside l as well as in the P.V weights."""
    from repro_torch.kernels.flash_decode import CHUNK

    q, kp, vp, tables, lengths = args
    pool, bs = kp.shape[0], kp.shape[1]
    nb = tables.shape[1]
    wrong = {}
    for fault, tile in (("no length mask", bs), ("no in-chunk length mask", CHUNK)):
        end = ((lengths + tile - 1) // tile * tile).clamp(max=nb * bs).to(torch.int32)
        wrong[fault] = ref.ref_flash_decode_paged(q, kp, vp, tables, end, **kw)
    parts = ref.ref_flash_decode_paged_partials(*args, **kw, chunk=span)
    wrong.update(_merge_faults(torch, ref, parts, q.dtype))
    # the logical block that holds the first position of block j's chunk
    j = torch.arange(nb, device=tables.device)
    first = j * bs // CHUNK * CHUNK // bs
    contiguous = (tables[:, first].long() + (j - first)) % pool
    wrong["chunk reads contiguous pages"] = ref.ref_flash_decode_paged(
        q, kp, vp, contiguous.to(torch.int32), lengths, **kw)
    if kw["k_scale"] is not None:
        b, hkv, d = q.shape[0], kp.shape[2], kp.shape[3]
        pos = torch.arange(nb * bs, device=tables.device)
        chunk_page = tables[:, pos // CHUNK * CHUNK // bs].long()      # (B, NB * BS)
        store = [x[tables.long()].reshape(b, nb * bs, hkv, d) for x in (kp, vp)]
        wrong["one scale per chunk"] = ref.ref_merge_partials(*ref.ref_flash_decode_partials(
            q, *store, lengths, kw["softcap"], span, k_scale=kw["k_scale"][chunk_page],
            v_scale=kw["v_scale"][chunk_page])).to(q.dtype)
        # over V = 1 the P.V weights sum to sum_s p_s * v_scale_s: that l
        m, _, acc, valid = parts
        _, _, acc1, _ = ref.ref_flash_decode_paged_partials(
            q, kp, torch.ones_like(vp), tables, lengths, **kw, chunk=span)
        wrong["V scale inside l"] = ref.ref_merge_partials(m, acc1[..., 0], acc,
                                                           valid).to(q.dtype)
    return wrong


def _slot_flash_decode_checks(torch, timer: Timer, cfg, gen) -> dict:
    """Kernel 4 over a contiguous slot cache at the slot path's width:
    B = max_slots = 8, S = max_seq = 1024, 32 / 4 heads x 128."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode, ref
    from repro_torch.kernels.flash_decode import CHUNK, split_plan

    b, s, hq, hkv, d = 8, 1024, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    tile = CHUNK                            # positions of one split-pass chunk
    q = torch.randn((b, hq, d), generator=gen, device=DEVICE)
    k = torch.randn((b, s, hkv, d), generator=gen, device=DEVICE)
    v = torch.randn((b, s, hkv, d), generator=gen, device=DEVICE)
    # 0, 1, lengths that are multiples of no tile, and the full cache
    lengths = torch.tensor([s, 0, 1, 37, 333, 517, 1001, 765], dtype=torch.int32,
                           device=DEVICE)
    tile_end = ((lengths + tile - 1) // tile * tile).to(torch.int32)
    n_tok = int(lengths.sum())
    fd = {}
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        rtol, atol = FD_TOL[dtype_name]
        qq, kk, vv = q.to(dtype), k.to(dtype), v.to(dtype)
        for softcap in (0.0, 30.0):
            args = (qq * 10 if softcap else qq, kk, vv, lengths)
            name = f"flash_decode[{dtype_name},softcap={softcap}]"
            got = flash_decode(*args, softcap=softcap)
            want = ref.ref_flash_decode(*args, softcap)
            torch.cuda.synchronize()
            err = check_close(name, got, want, rtol, atol)
            if not (got[1] == 0).all():
                raise AssertionError(f"{name}: length-0 row is not exactly zero")
            wrong = {"no in-chunk length mask": ref.ref_flash_decode(
                args[0], kk, vv, tile_end, softcap)}
            if softcap:
                wrong["no softcap"] = ref.ref_flash_decode(*args, 0.0)
            span = split_plan(b, s, hq, hkv, d, kk.element_size()).span
            wrong.update(_merge_faults(torch, ref, ref.ref_flash_decode_partials(
                *args, softcap, span), qq.dtype))
            for fault, bad in wrong.items():
                if max_excess(bad, want, rtol, atol)[1] <= 0:
                    raise AssertionError(f"{name}: the tolerance cannot tell {fault!r} "
                                         f"from the plain version")
            row = dict(err=err)
            if dtype == torch.bfloat16:
                row["ms"] = timer.ms(lambda: flash_decode(*args, softcap=softcap))
                row["plain"] = timer.ms(lambda: ref.ref_flash_decode(*args, softcap))
                nbytes = 2 * q.numel() * 2 + n_tok * hkv * d * 2 * 2 + b * 4
                row["bound"] = _bound(nbytes, 4 * n_tok * hq * d, dtype_name)
                row["tb_s"] = _tb_s(nbytes, row["ms"])
                row["lib"] = None
                if not softcap:
                    # the library yardstick: one SDPA call with a boolean length
                    # mask over the same (B, Hkv, S, D) cache, grouped queries
                    mask = (torch.arange(s, device=DEVICE)[None, :]
                            < lengths[:, None])[:, None, None, :]
                    qs, ks, vs = qq[:, :, None, :], kk.transpose(1, 2), vv.transpose(1, 2)

                    def sdpa():
                        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                              enable_gqa=True)
                    row["lib"] = timer.ms(sdpa)
                    kernel_us = timer.device_us(lambda: flash_decode(*args))
                    log(f"device time flash_decode: kernel [{kernel_us}] "
                        f"sdpa [{timer.device_us(sdpa)}]")
                log(f"kernel flash_decode dtype={dtype_name} softcap={softcap} B={b} S={s} "
                    f"tokens={n_tok}: max_abs_err={err:.3e} (rtol {rtol}, atol {atol}) "
                    f"ms={row['ms']:.4f} plain_ms={row['plain']:.4f} library_ms"
                    f"(sdpa)={'none' if row['lib'] is None else format(row['lib'], '.4f')} "
                    f"bound_ms={row['bound'][0]:.4f} ({row['bound'][1]}) {row['tb_s']}")
            else:
                log(f"kernel flash_decode dtype={dtype_name} softcap={softcap}: "
                    f"max_abs_err={err:.3e} (rtol {rtol}, atol {atol})")
            fd[(dtype_name, softcap)] = row
    main = fd[("bfloat16", 0.0)]
    return {"flash_decode": dict(
        source="src/repro_torch/kernels/csrc/flash_decode.cu",
        replaces="src/repro/kernels/flash_decode.py:73",
        max_abs_err=max(v["err"] for v in fd.values()), ms=main["ms"],
        plain_ms=main["plain"], bound_ms=main["bound"][0], bound_by=main["bound"][1],
        library_ms=main["lib"])}


# (arch, positions a row, kernel 1 too) of the families', variants' and ssm
# decode shapes: gemma2's 8 / 4 heads x 256 with softcap 50 over its
# 4864-position runs past the 4096 window, granite-20b's 48 query heads on
# one KV head over 1024, llama4's 40 / 8 heads x 128 over its slot runs'
# 1024 (kernel 4 only: the paged layout rejects the interleaved stack), and
# zamba2's shared attention, 32 / 32 heads x 64 over 1024 (kernel 4 only:
# the paged layout rejects the hybrid stack)
FAMILY_SHAPES = (("gemma2-2b", 4864, True), ("granite-20b", 1024, True),
                 ("llama4-maverick-400b-a17b", 1024, False), ("zamba2-1.2b", 1024, False))


def _family_decode_checks(torch, timer: Timer, gen) -> dict:
    """Kernels 1 and 4 at the shapes the families, variants and ssm phases
    give them (B = 8, 16-position pages for kernel 1; bf16, and for gemma2 int8 pages too;
    softcap 0 and the family's own), each against its plain version with
    the fault checks of the qwen3 shapes and timed as they are (CUDA events,
    and at softcap 0 the profiler's device time, which a loaded host does
    not inflate), kernel 4 beside one SDPA call at softcap 0.  Returns each
    kernel's largest error."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode, flash_decode_paged, ref
    from repro_torch.kernels.flash_decode import CHUNK, split_plan

    rtol, atol = FD_TOL["bfloat16"]
    errs = {"flash_decode_paged": 0.0, "flash_decode": 0.0}

    def gate(name, got, want, wrong, lengths):
        err = check_close(name, got, want, rtol, atol)
        if not (got[lengths == 0] == 0).all():
            raise AssertionError(f"{name}: length-0 row is not exactly zero")
        for fault, bad in wrong.items():
            if max_excess(bad, want, rtol, atol)[1] <= 0:
                raise AssertionError(f"{name}: the tolerance cannot tell {fault!r} "
                                     f"from the plain version")
        return err

    for arch, s, paged in FAMILY_SHAPES:
        fc = get_config(arch)
        b, hq, hkv, d = 8, fc.num_heads, fc.num_kv_heads, fc.head_dim
        caps = sorted({0.0, fc.attn_logit_softcap})
        lengths = torch.tensor([s, 0, 1, CHUNK + 1, s // 2 + 3, s - 1, 517, 3 * s // 4],
                               dtype=torch.int32, device=DEVICE)
        n_tok = int(lengths.sum())
        q = torch.randn((b, hq, d), generator=gen, device=DEVICE).to(torch.bfloat16)
        shape = f"family={arch} B={b} heads={hq}/{hkv}x{d}"

        bs, nb = 16, s // 16
        kp, vp, kq, vq, ksc, vsc, tables = _paged_pool(torch, gen, b, nb, bs, hkv, d)
        kinds = [("bf16", (kp, vp, None, None))] if paged else []
        if arch == "gemma2-2b":
            kinds.append(("int8", (kq, vq, ksc, vsc)))
        for pages, (kk, vv, ks, vs) in kinds:
            plan = split_plan(b, nb * bs, hq, hkv, d, kk.element_size())
            for cap in caps:
                args = (q * 10 if cap else q, kk, vv, tables, lengths)
                kw = dict(k_scale=ks, v_scale=vs, softcap=cap)
                name = f"flash_decode_paged[{arch},{pages},softcap={cap}]"
                wrong = _paged_faults(torch, ref, args, kw, plan.span)
                if cap:
                    wrong["no softcap"] = ref.ref_flash_decode_paged(*args, **{**kw, "softcap": 0.0})
                if ks is not None:
                    wrong["stale page scale"] = ref.ref_flash_decode_paged(
                        *args, **{**kw, "k_scale": ks.roll(1), "v_scale": vs.roll(1)})
                err = gate(name, flash_decode_paged(*args, **kw),
                           ref.ref_flash_decode_paged(*args, **kw), wrong, lengths)
                errs["flash_decode_paged"] = max(errs["flash_decode_paged"], err)
                ms = timer.ms(lambda: flash_decode_paged(*args, **kw))
                plain = timer.ms(lambda: ref.ref_flash_decode_paged(*args, **kw))
                kv_item = kk.element_size()
                n_pages = int(((lengths + bs - 1) // bs).sum())
                nbytes = (2 * q.numel() * 2 + n_tok * hkv * d * 2 * kv_item
                          + tables.numel() * 4 + b * 4 + (2 * 4 * n_pages if ks is not None else 0))
                bound = _bound(nbytes, 4 * n_tok * hq * d, "bfloat16")
                if not cap:
                    log(f"device time flash_decode_paged {shape} pages={pages}: kernel "
                        f"[{timer.device_us(lambda: flash_decode_paged(*args, **kw))}]")
                log(f"kernel flash_decode_paged {shape} BS={bs} NB={nb} pages={pages} "
                    f"softcap={cap} tokens={n_tok} n_split={plan.n_split}: max_abs_err="
                    f"{err:.3e} (rtol {rtol}, atol {atol}) faults_outside_gate={len(wrong)} "
                    f"ms={ms:.4f} plain_ms={plain:.4f} library_ms=none bound_ms={bound[0]:.4f} "
                    f"({bound[1]}) {_tb_s(nbytes, ms)}")
        del kp, vp, kq, vq

        k = torch.randn((b, s, hkv, d), generator=gen, device=DEVICE).to(torch.bfloat16)
        v = torch.randn((b, s, hkv, d), generator=gen, device=DEVICE).to(torch.bfloat16)
        tile_end = ((lengths + CHUNK - 1) // CHUNK * CHUNK).clamp(max=s).to(torch.int32)
        plan = split_plan(b, s, hq, hkv, d, 2)
        for cap in caps:
            args = (q * 10 if cap else q, k, v, lengths)
            name = f"flash_decode[{arch},softcap={cap}]"
            wrong = {"no in-chunk length mask": ref.ref_flash_decode(args[0], k, v, tile_end, cap)}
            if cap:
                wrong["no softcap"] = ref.ref_flash_decode(*args, 0.0)
            wrong.update(_merge_faults(torch, ref, ref.ref_flash_decode_partials(
                *args, cap, plan.span), q.dtype))
            err = gate(name, flash_decode(*args, softcap=cap), ref.ref_flash_decode(*args, cap),
                       wrong, lengths)
            errs["flash_decode"] = max(errs["flash_decode"], err)
            ms = timer.ms(lambda: flash_decode(*args, softcap=cap))
            plain = timer.ms(lambda: ref.ref_flash_decode(*args, cap))
            nbytes = 2 * q.numel() * 2 + n_tok * hkv * d * 2 * 2 + b * 4
            bound = _bound(nbytes, 4 * n_tok * hq * d, "bfloat16")
            lib = "none (SDPA takes no softcap)"
            if not cap:
                mask = (torch.arange(s, device=DEVICE)[None, :]
                        < lengths[:, None])[:, None, None, :]
                qs, kt, vt = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)

                def sdpa():
                    return F.scaled_dot_product_attention(qs, kt, vt, attn_mask=mask,
                                                          enable_gqa=True)
                lib = f"{timer.ms(sdpa):.4f}"
                log(f"device time flash_decode {shape}: kernel "
                    f"[{timer.device_us(lambda: flash_decode(*args))}] sdpa "
                    f"[{timer.device_us(sdpa)}]")
            log(f"kernel flash_decode {shape} S={s} softcap={cap} tokens={n_tok} "
                f"n_split={plan.n_split}: max_abs_err={err:.3e} (rtol {rtol}, atol {atol}) "
                f"faults_outside_gate={len(wrong)} ms={ms:.4f} plain_ms={plain:.4f} "
                f"library_ms(sdpa)={lib} bound_ms={bound[0]:.4f} ({bound[1]}) "
                f"{_tb_s(nbytes, ms)}")
        del k, v
    return errs


# the router's variant cases: decode and a 512-token bucket at the default
# plans, and a forced plan of several CTAs and rounds
VARIANT_ROUTER_CASES = ((8, None), (512, None), (600, dict(ctas=3, warps=5, per_warp=3)))
# capacities of the variants' grouped GEMMs: decode (T = 8) and the largest a
# 512-token prefill gives (deepseek: 1.25 * 6 * 512 / 160 + 1 -> 32)
VARIANT_CAPACITIES = (8, 32)


def _variant_kernel_checks(torch, timer: Timer, gen) -> dict:
    """Kernels 2, 3 and 5 at the MoE variants' shapes, run before any model
    is resident (the plain ``ref_moe_gemm`` upcasts llama4's 10.7 GB of
    bf16 weights to 21.5 GB of f32): the router at deepseek-v2's E = 160,
    k = 6 (five probabilities a lane) and llama4's E = 128, k = 1, with
    identity and R = 8 replica tables and as kernel 5 (VARIANT_ROUTER_CASES);
    ``moe_gemm`` in bf16 at (E, C, 5120) x (E, 5120, F) and (E, C, F) x
    (E, F, 5120) for deepseek's E = 160, F = 1536 and llama4's E = 128,
    F = 8192, C in VARIANT_CAPACITIES.  Returns each kernel's largest error."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import normal

    errs = {"topk_router_replicated": 0.0, "topk_router": 0.0, "moe_gemm": 0.0}
    for arch in (DEEPSEEK, LLAMA4):
        vc = get_config(arch)
        e, dm, f = vc.num_experts, vc.d_model, vc.moe_d_ff
        router = _router_checks(torch, timer, vc, gen, cases=VARIANT_ROUTER_CASES,
                                graph=False, tag=f"{arch},E={e},k={vc.moe_top_k},")
        for name in ("topk_router_replicated", "topk_router"):
            errs[name] = max(errs[name], router[name]["max_abs_err"])
        for proj, din, dout in (("gate/up", dm, f), ("down", f, dm)):
            # drawn a slice at a time: llama4's f32 transients would be 43 GB
            w = normal(gen, (e, din, dout), din ** -0.5, torch.bfloat16)
            for c in VARIANT_CAPACITIES:
                x = torch.randn((e, c, din), generator=gen, device=DEVICE).to(torch.bfloat16)
                row = _moe_gemm_case(torch, timer, x, w, "bfloat16", f"{arch} C={c} {proj}")
                errs["moe_gemm"] = max(errs["moe_gemm"], row["err"])
            del w, x
            torch.cuda.empty_cache()
    return errs


# (T, route_plan overrides) of the router phase: default plans at decode
# (one CTA), at 512 and 1024 (n = 4 and 8 CTAs, one round) and at 5000
# tokens (two rounds), and two forced plans with many rounds and odd sizes
ROUTER_CASES = ((1, None), (8, None), (512, None), (1024, None), (5000, None),
                (1024, dict(ctas=2, warps=4, per_warp=8)),
                (600, dict(ctas=3, warps=5, per_warp=3)))


def _router_hot(e: int) -> tuple:
    """The skewed logits' two hot experts."""
    return 1, e - 2


def _router_logits(torch, gen, t: int, e: int, kind: str):
    """Router logits: "random" N(0, 4); "tied", rounded to multiples of 0.5
    in [-1, 1] (many equal probabilities); "skewed", one hot expert a
    token: even tokens put the first hot expert first and the second second,
    odd tokens the other way round (see ``_router_hot``), so one slot's
    selections span every warp, CTA and round, and the second hot expert
    alternates between selections 0 and 1."""
    x = torch.randn((t, e), generator=gen, device=DEVICE) * 2.0
    if kind == "tied":
        x = (torch.round(x) / 2).clamp(-1, 1)
    elif kind == "skewed":
        even = torch.arange(t, device=DEVICE) % 2 == 0
        first, second = _router_hot(e)
        x[:, first] = torch.where(even, 20.0, 16.0)
        x[:, second] = torch.where(even, 16.0, 20.0)
    return x


def _router_placement(torch, e: int, gen, k: int = 8):
    """R = 8 replica slots (S = 136 at E = 128), shuffled: the first hot
    expert in three slots (four where three divides k, since selection
    t * k + j and selection j pick the same one of c copies when c divides
    k), experts other than the hot ones in two, the second hot expert in
    one."""
    from repro_torch.models.moe import ExpertPlacement
    hot = _router_hot(e)
    extra = 2 if k % 3 else 3
    others = [x for x in range(10, e, max(1, (e - 10) // 6)) if x not in hot][:8 - extra]
    inv = torch.cat([torch.arange(e), torch.tensor([hot[0]] * extra + others)])
    inv = inv[torch.randperm(len(inv), generator=gen, device=DEVICE).cpu()]
    return ExpertPlacement.from_slot_map(inv.to(DEVICE), e, device=DEVICE)


def _router_faults(torch, ref, want, plc, plan, num_slots: int, k: int) -> dict:
    """Four wrong counts a router kernel could give, each as (slots, pos)
    from the plain versions on the same inputs: the carry across rounds
    dropped; ranks within the CTA only (no lower-CTA sum); positions in
    selection-major order; and, with replica tables ``plc``, the replica
    index from j instead of the global selection index t * k + j.
    ``want``: the plain (ids, slots, pos)."""
    ids, slots, pos = want
    terms = ref.ref_router_plan_terms(slots, plan, num_slots)
    wrong = {"carry dropped across rounds": (slots, pos - terms["carry"]),
             "no lower-CTA sum": (slots, pos - terms["lower_ctas"]),
             "selection-major order": (slots, ref.slot_positions(slots.t(), num_slots).t())}
    if plc is not None:
        j = torch.arange(k, device=ids.device)[None, :]
        by_j = plc.replica_slots.long()[ids.long(), j % plc.replica_count.long()[ids.long()]
                                        .clamp(min=1)].int()
        wrong["replica index from j"] = (by_j, ref.slot_positions(by_j, num_slots))
    return wrong


def _router_checks(torch, timer: Timer, cfg, gen, cases=ROUTER_CASES, graph: bool = True,
                   tag: str = "") -> dict:
    """Kernels 2 and 5 (one launch a call, one cluster) against their plain
    versions at every ROUTER_CASES plan: kernel 2 with identity tables (the
    paged path) and with R = 8 replica tables, kernel 5 (no tables); random,
    tied and skewed logits.  Gates within 1e-5, integers exact, the plain
    mirror of the cluster count equal to the plain positions, and on skewed
    logits each of ``_router_faults`` outside the gate wherever it can
    differ (carry: rounds > 1; lower CTAs: n > 1; order: T > 1 and k > 1;
    replica index: replica tables, T > 1).  The profiler shows one kernel
    launch a call at every case.  At T = 8, 512 and 1024: timed ms, device
    us, host us a call without a synchronize, beside ``launch_floor_ms``
    (one single-element ``zero_()`` under the same Timer).  Then, with
    ``graph``, one call captured in a CUDA graph and replayed on new
    logits.  ``cases`` replaces ROUTER_CASES (the variants' shapes take
    fewer); ``tag`` prefixes each case's name."""
    from repro_torch.kernels import ref, topk_router, topk_router_replicated
    from repro_torch.kernels.topk_router import route_plan
    from repro_torch.models.moe import ExpertPlacement

    e, k = cfg.num_experts, cfg.moe_top_k
    one = torch.zeros(1, device=DEVICE)
    floor = timer.ms(lambda: one.zero_())
    log(f"router launch_floor_ms={floor:.4f} (one single-element zero_())")
    placements = {"identity tables": ExpertPlacement.identity(e, device=DEVICE),
                  "R=8": _router_placement(torch, e, gen, k), "kernel 5": None}
    rows, errs = {}, {name: [] for name in placements}
    shown = {name: 0 for name in ("carry dropped across rounds", "no lower-CTA sum",
                                  "selection-major order", "replica index from j")}
    possible = dict.fromkeys(shown, False)
    for t, over in cases:
        for tables, plc in placements.items():
            s = e if plc is None else plc.num_slots
            plan = route_plan(t, e, k, s, **(over or {}))
            kw = dict(plan=plan) if over else {}
            for kind in ("random", "tied", "skewed"):
                name = f"router[{tag}T={t},{tables},{kind},plan={tuple(plan[:4])}]"
                logits = _router_logits(torch, gen, t, e, kind)
                if plc is None:
                    def call():
                        return topk_router(logits, k, **kw)

                    def plain():
                        return ref.ref_topk_router(logits, k)
                    (gates, ids, pos), (wg, wi, wp) = call(), plain()
                    got, want = (ids, ids, pos), (wi, wi, wp)
                else:
                    args = (logits, k, plc.replica_slots, plc.replica_count, s)

                    def call():
                        return topk_router_replicated(*args, **kw)

                    def plain():
                        return ref.ref_topk_router_replicated(*args)
                    (gates, *got), (wg, *want) = call(), plain()
                torch.cuda.synchronize()
                err = check_close(name, gates, wg, 1e-5)
                for what, g_, w_ in zip(("ids", "slots", "pos"), got, want):
                    if not torch.equal(g_, w_):
                        raise AssertionError(f"{name}: {what} differ in "
                                             f"{int((g_ != w_).sum())} places")
                if not torch.equal(ref.ref_router_plan_positions(want[1], plan, s), want[2]):
                    raise AssertionError(f"{name}: the plain mirror of the cluster count "
                                         f"disagrees with the plain positions")
                line = f"kernel {name}: max_abs_err={err:.3e} (tol 1e-5) ints_exact=True"
                if kind == "skewed":
                    faults = _router_faults(torch, ref, want, plc, plan, s, k)
                    can = {"carry dropped across rounds": plan.rounds > 1,
                           "no lower-CTA sum": plan.ctas > 1,
                           "selection-major order": t > 1 and k > 1,
                           "replica index from j": s > e and t > 1}
                    for fault, (fs, fp) in faults.items():
                        possible[fault] |= can[fault]
                        outside = not (torch.equal(fs, want[1]) and torch.equal(fp, want[2]))
                        if can[fault] and not outside:
                            raise AssertionError(f"{name}: the gate cannot tell {fault!r} "
                                                 f"from the plain version")
                        shown[fault] += outside
                    line += f" faults_outside_gate={sum(can.values())}"
                if kind == "random":
                    # one kernel launch a call, whatever T and plan
                    drows = timer.device_rows(call, iters=5)
                    if len(drows) != 1 or drows[0][2] != 5 or "rt::router::" not in drows[0][0]:
                        raise AssertionError(f"{name}: not one router launch a call: {drows}")
                    line += " launches_per_call=1"
                if kind == "random" and over is None and t in (8, 512, 1024):
                    row = dict(err=err, ms=timer.ms(call), host_us=timer.host_us(call),
                               plain=timer.ms(plain))
                    nbytes = t * e * 4 + (3 if plc is None else 4) * t * k * 4
                    if plc is not None:
                        nbytes += (plc.replica_slots.numel() + e) * 4
                    row["bound"] = _bound(nbytes, 5 * t * e, "float32")
                    rows[(t, tables)] = row
                    log(f"device time router {tag}T={t} {tables} plan={tuple(plan[:4])}: kernel "
                        f"[{timer.device_us(call)}] host_us_per_call={row['host_us']:.2f} "
                        f"launch_floor_ms={floor:.4f}")
                    line += (f" ms={row['ms']:.4f} ({row['ms'] / floor:.2f}x launch floor) "
                             f"plain_ms={row['plain']:.4f} library_ms=none "
                             f"bound_ms={row['bound'][0]:.6f} ({row['bound'][1]}) "
                             f"{_tb_s(nbytes, row['ms'])}")
                errs[tables].append(err)
                log(line)
    if not all(shown[fault] for fault, can in possible.items() if can):
        raise AssertionError(f"router {tag}: a fault was never shown outside the gate: "
                             f"{shown}")
    log(f"router {tag}faults outside the gate (skewed cases): {shown}")
    if graph:
        _router_graph_check(torch, gen, placements["R=8"], e, k)

    def entry(tables, replaces, err):
        main = rows[(8, tables)]
        return dict(source="src/repro_torch/kernels/csrc/topk_router.cu", replaces=replaces,
                    max_abs_err=err, ms=main["ms"], plain_ms=main["plain"],
                    bound_ms=main["bound"][0], bound_by=main["bound"][1], library_ms=None)
    return {"topk_router_replicated": entry("identity tables",
                                            "src/repro/kernels/topk_router.py:155",
                                            max(errs["identity tables"] + errs["R=8"])),
            "topk_router": entry("kernel 5", "src/repro/kernels/topk_router.py:145",
                                 max(errs["kernel 5"]))}


def _router_graph_check(torch, gen, plc, e: int, k: int) -> None:
    """One replicated router call captured in a CUDA graph at T = 8 and at
    T = 512 (four CTAs), replayed on logits written into the captured input
    afterwards: equal, bit for bit, to the eager call on those logits."""
    from repro_torch.kernels import topk_router_replicated
    for t in (8, 512):
        x = _router_logits(torch, gen, t, e, "random")
        args = (x, k, plc.replica_slots, plc.replica_count, plc.num_slots)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            topk_router_replicated(*args)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = topk_router_replicated(*args)
        x.copy_(_router_logits(torch, gen, t, e, "skewed"))
        graph.replay()
        eager = topk_router_replicated(*args)
        torch.cuda.synchronize()
        for what, g_, w_ in zip(("gates", "ids", "slots", "pos"), captured, eager):
            if not torch.equal(g_, w_):
                raise AssertionError(f"router CUDA graph T={t}: replayed {what} differ "
                                     f"from the eager call")
        log(f"router CUDA graph T={t}: captured once, replayed on new logits, equal to "
            f"the eager call")
        del graph


def _merge_faults(torch, ref, parts, dtype) -> dict:
    """Two wrong merges of a decode kernel's split partials ``parts`` (m, l,
    acc, valid from the plain mirror, one partial per split span), as
    ``dtype``: one that drops each row's last partial, and one that adds the
    partials without the e^(m_i - M) rescale."""
    m, l, acc, valid = parts
    last = valid.long().cumsum(-1) == valid.sum(-1, keepdim=True)
    vm = valid[:, None, :]
    no_rescale = (torch.where(vm[..., None], acc, 0.0).sum(-2)
                  / torch.where(vm, l, 0.0).sum(-1, keepdim=True).clamp(min=1e-20))
    return {"last partial chunk dropped":
            ref.ref_merge_partials(m, l, acc, valid & ~last).to(dtype),
            "merge without rescale": no_rescale.to(dtype)}


def _tb_s(nbytes: int, ms: float) -> str:
    """The achieved rate of the bytes the bound counts."""
    return f"achieved_tb_s={nbytes / (ms * 1e-3) / 1e12:.3f}"


def _bound(nbytes: int, flops: int, dtype_name: str) -> tuple:
    """(least milliseconds, what bounds it): the larger of the bytes over the
    memory rate and the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------------- reference check

def reference_phase(torch, cfg) -> None:
    """One f32 decode step at full width through the kernels (fused router +
    grouped GEMMs, paged flash-decode) against the plain path (gather
    dispatch, attention over gathered pages) on the same pages."""
    from repro_torch.models import model as M

    cfg32 = cfg.replace(num_layers=2, dtype="float32")
    params = M.init_params(cfg32, seed=SEED + 1, device=DEVICE)
    _paged_step_vs_plain(torch, cfg32, params, "")
    _replicated_slot_step(torch, cfg32, params)
    del params
    torch.cuda.empty_cache()


def _paged_step_vs_plain(torch, cfg32, params, label: str) -> None:
    """Three prompts prefilled into a paged backend, then one decode step of
    ``decode_step_paged`` through the kernels (kernel 1 once per global
    layer; for a MoE model the fused router and grouped GEMMs) and one
    through the plain path (gather dispatch, attention over gathered pages),
    on the same pages: logits within the f32 gate, prefill tokens equal."""
    from repro_torch import kernels as K
    from repro_torch.core.types import Request
    from repro_torch.models import model as M
    from repro_torch.serving.backend import TorchBackend

    rng = torch.Generator().manual_seed(SEED + 1)
    outs = []
    for fused in (True, False):
        be = TorchBackend(cfg32, params, max_slots=4, max_seq=256, kv_layout="paged",
                          dispatch_mode="fused" if fused else "gather",
                          use_kernels=fused, device=DEVICE)
        rng.manual_seed(SEED + 1)
        for i, plen in enumerate((40, 97, 130)):
            toks = torch.randint(0, cfg32.vocab_size, (plen,), generator=rng).numpy()
            be.start(Request(i, plen, 4, 0.0, prompt_tokens=toks), 0.0)
        tokens = torch.as_tensor(be.slot_last_token.astype("int64"), device=DEVICE)[:, None]
        K.reset_launch_counts()
        with torch.no_grad():
            logits, _, _ = M.decode_step_paged(
                params, cfg32, tokens, be.kv.pages, be.kv.device_tables(),
                be.kv.positions(), dispatch_mode=be.dispatch_mode, use_kernel=fused)
        paged = K.flash_decode_paged.launches
        if paged != (_n_global(cfg32) if fused else 0):
            raise AssertionError(f"reference{label}: kernel 1 launched {paged} times in "
                                 f"one decode step of {_n_global(cfg32)} global layers")
        outs.append((logits[:3], be.slot_last_token[:3].copy()))
        del be
    torch.cuda.synchronize()
    (lk, tk), (lp, tp) = outs
    err = check_close(f"decode_step_paged f32{label} kernels vs plain", lk, lp,
                      TOL["float32"])
    if list(tk) != list(tp):
        raise AssertionError(f"prefill greedy tokens differ: {tk} vs {tp}")
    log(f"reference{label}: f32 full-width decode step, kernels vs plain path: "
        f"max_abs_err={err:.3e} (tol {TOL['float32']}), logits {tuple(lk.shape)}, "
        f"prefill tokens equal {[int(x) for x in tk]}")


def _replicated_slot_step(torch, cfg32, params, label: str = "",
                          replicate: bool = True) -> None:
    """The slot layout, under a replicated, non-identity placement (with
    ``replicate``): the "eplb" solver's slot map for seeded skewed counts
    with R = 4 replica slots (S = E + 4), the expert weights gathered into
    it by the backend's ``apply_placement``.  Three prompts prefilled, then
    one decode step through the router and grouped-GEMM kernels against the
    plain gather path: in f32 within ``TOL``, in bf16 within ``moe_gemm``'s
    gate (``MG_TOL``, atol a fraction of the plain logits' rms).  An MLA
    model's fused step is also taken with ``mla_absorb=True`` on a copy of
    the cache and held to the naive one."""
    import numpy as np
    from repro_torch.core.eplb import ExpertRebalancer
    from repro_torch.core.placement import eplb_placement_rep
    from repro_torch.core.types import Request
    from repro_torch.models import model as M
    from repro_torch.models.moe import ExpertPlacement
    from repro_torch.serving.backend import TorchBackend

    e = cfg32.num_experts
    slot_map = plc = None
    if replicate:
        counts = np.random.default_rng(SEED + 2).pareto(1.0, size=(cfg32.num_layers, e)) + 1.0
        slot_map = eplb_placement_rep(counts, 4, 4)
        plc = ExpertPlacement.from_slot_map(slot_map, e)
        if len(slot_map) != e + 4 or int(plc.replica_count.max()) < 2 \
                or np.array_equal(slot_map[:e], np.arange(e)):
            raise AssertionError(f"reference{label}: the slot map is not a replicated, "
                                 "non-identity one")
    rng = torch.Generator().manual_seed(SEED + 3)
    outs = []
    absorb_err = None
    for fused in (True, False):
        rb = None
        if replicate:
            rb = ExpertRebalancer(cfg32, 4, redundancy=4)
            rb.slot_map = slot_map
        be = TorchBackend(cfg32, params, max_slots=4, max_seq=256, kv_layout="slot",
                          dispatch_mode="fused" if fused else "gather", rebalancer=rb,
                          device=DEVICE)
        rng.manual_seed(SEED + 3)
        for i, plen in enumerate((40, 97, 130)):
            toks = torch.randint(0, cfg32.vocab_size, (plen,), generator=rng).numpy()
            be.start(Request(i, plen, 4, 0.0, prompt_tokens=toks), 0.0)
        if replicate and (be.relocations != 1
                          or be.params["blocks"]["moe"]["w_gate"].shape[1] != e + 4):
            raise AssertionError(f"reference{label}: apply_placement did not gather "
                                 f"{e + 4} slots")
        tokens = torch.as_tensor(be.slot_last_token.astype("int64"), device=DEVICE)[:, None]
        kw = dict(placements=be._placements(), dispatch_mode=be.dispatch_mode)
        with torch.no_grad():
            if fused and cfg32.attention_type == "mla":
                cache = copy.deepcopy(be.kv.cache)
                absorbed, _, _ = M.decode_step(be.params, cfg32, tokens, cache,
                                               be.kv.positions(), mla_absorb=True, **kw)
                del cache
            logits, _, _ = M.decode_step(be.params, cfg32, tokens, be.kv.cache,
                                         be.kv.positions(), **kw)
        outs.append((logits[:3], be.slot_last_token[:3].copy()))
        del be
    torch.cuda.synchronize()
    (lk, tk), (lp, tp) = outs
    if cfg32.dtype == "float32":
        tol = (TOL["float32"], TOL["float32"])
    else:
        rtol, atol_frac = MG_TOL[cfg32.dtype]
        tol = (rtol, atol_frac * float(lp.float().square().mean().sqrt()))
    err = check_close(f"decode_step {cfg32.dtype}{label}, kernels vs plain", lk, lp, *tol)
    if cfg32.attention_type == "mla":
        absorb_err = check_close(f"decode_step {cfg32.dtype}{label} mla_absorb=True vs False",
                                 absorbed[:3], lk, *tol)
    if list(tk) != list(tp):
        raise AssertionError(f"prefill greedy tokens differ: {tk} vs {tp}")
    placement = (f"replicated placement (S={len(slot_map)}, max copies "
                 f"{int(plc.replica_count.max())})" if replicate else "identity placement")
    log(f"reference{label}: {cfg32.dtype} full-width slot decode step, {placement}, "
        f"kernels vs plain path: max_abs_err={err:.3e} (rtol {tol[0]}, atol {tol[1]:.3e}), "
        + ("" if absorb_err is None else
           f"mla_absorb=True vs False max_abs_err={absorb_err:.3e} (same gate), ")
        + f"prefill tokens equal {[int(x) for x in tk]}")


# ----------------------------------------------------------------------------- engine

def _requests(cfg, n_req: int, max_new: int, lo: int = 128, hi: int = 512,
              prefix_len: int = 256, share_every: int = 2):
    """``n_req`` requests of ``lo``-``hi`` prompt tokens, every
    ``share_every``-th one starting with a shared ``prefix_len``-token
    prefix, all submitted at t = 0."""
    import numpy as np
    from repro_torch.core.types import Request

    rng = np.random.default_rng(SEED)
    prefix = rng.integers(0, cfg.vocab_size, prefix_len)
    reqs = []
    for i in range(n_req):
        plen = int(rng.integers(lo, hi + 1))
        if i % share_every == 0:
            toks = np.concatenate([prefix, rng.integers(0, cfg.vocab_size,
                                                        max(plen - prefix_len, 1))])
        else:
            toks = rng.integers(0, cfg.vocab_size, plen)
        reqs.append(Request(i, len(toks), max_new, 0.0, prompt_tokens=toks))
    return reqs


def _serve(torch, eng, reqs, decode_fn: str, label: str, *, trace: bool = False,
           after_decode=None) -> dict:
    """Drive ``eng`` until every request finished, with every kernel's count
    set to 0 just before and read just after.  Counts the prefill and decode
    calls, checks their logits are finite, and times the backend's calls.
    ``after_decode(eng)`` runs right after each decode step is enqueued."""
    from repro_torch import kernels as K
    from repro_torch import tracing
    from repro_torch.models import model as M

    seen = {"prefill": 0, "decode": 0, "finite": True}
    orig_prefill, orig_decode = M.prefill, getattr(M, decode_fn)

    def prefill(*a, **kw):
        out = orig_prefill(*a, **kw)
        seen["prefill"] += 1
        seen["finite"] &= bool(out[0].isfinite().all())
        return out

    def decode(*a, **kw):
        out = orig_decode(*a, **kw)
        if after_decode is not None:
            after_decode(eng)
        seen["decode"] += 1
        seen["finite"] &= bool(out[0].isfinite().all())
        return out

    # host seconds in the backend's prefill and decode calls; each ends in a
    # device -> host copy of the next tokens, so it includes the device work
    secs = {"start": 0.0, "decode": 0.0}

    def timed(name, fn):
        def call(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            secs[name] += time.perf_counter() - t
            return out
        return call

    eng.backend.start = timed("start", eng.backend.start)
    eng.backend.decode = timed("decode", eng.backend.decode)
    M.prefill = prefill
    setattr(M, decode_fn, decode)
    prof = None
    try:
        torch.cuda.synchronize()
        if trace:
            # the device's events and the host's runtime calls: recording
            # every host operator as well slows the host it measures and
            # multiplies the trace's processing time
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r, 0.0)
        done, now = [], 0.0
        while len(done) < len(reqs) and eng.steps < 10_000:
            done += eng.step(now)
            now += 0.05
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in K.KERNELS}
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            tracing.last()                  # the engine's tracing session ends with it
        M.prefill = orig_prefill
        setattr(M, decode_fn, orig_decode)

    gen_tokens = sum(r.generated for r in done)
    log(f"engine[{label}]: requests={len(done)}/{len(reqs)} steps={eng.steps} "
        f"prefills={seen['prefill']} decode_steps={seen['decode']} "
        f"prompt_tokens={sum(r.prompt_len for r in done)} generated_tokens={gen_tokens} "
        f"wall_s={wall:.3f} generated_tokens_per_s={gen_tokens / wall:.2f} "
        f"launches={launches}")
    log(f"engine[{label}] time: prefill_s={secs['start']:.4f} "
        f"({1e3 * secs['start'] / max(seen['prefill'], 1):.3f} ms per request) "
        f"decode_s={secs['decode']:.4f} "
        f"({1e3 * secs['decode'] / max(seen['decode'], 1):.3f} ms per step of "
        f"{eng.max_slots} rows) scheduler_and_rest_s="
        f"{wall - secs['start'] - secs['decode']:.4f}")
    if prof is not None:
        rows = _report_trace(prof, wall, label, seen)
        if not rows:
            raise EmptyTrace(f"trace[{label}]: the profiler recorded no device event")
        _check_router_trace(rows, launches, label)
    if len(done) != len(reqs):
        raise AssertionError(f"engine[{label}]: only {len(done)}/{len(reqs)} finished")
    if not seen["finite"]:
        raise AssertionError(f"engine[{label}]: non-finite logits")
    if any(r.generated != r.max_new_tokens for r in done):
        raise AssertionError(f"engine[{label}]: a request stopped short of max_new_tokens")
    L = eng.cfg.num_moe_layers()            # 0 for a dense model
    path = {"topk_router_replicated": (seen["prefill"] + seen["decode"]) * L,
            "moe_gemm": 3 * (seen["prefill"] + seen["decode"]) * L}
    return dict(launches=launches, path=path, seen=seen, wall=wall,
                tokens_per_s=gen_tokens / wall)


def engine_run(torch, cfg, params, *, n_req: int, max_new: int, kv_quant, label: str,
               trace: bool = False, reqs=None, max_slots: int = 8, max_seq: int = 1024,
               prefill_budget: int = 512) -> dict:
    """Serve ``n_req`` requests (or ``reqs``) on the paged layout with no
    expert level and check the run: prefix pages shared, the pool drained,
    and launch counts equal to the path's (kernel 1 once per global layer a
    decode step: a windowed local layer attends in plain PyTorch).
    ``trace`` records the run with torch.profiler and reports the device's
    busy share and kernel times."""
    from repro_torch.serving.engine import Engine

    eng = Engine(0, cfg, params, variant="gimbal", expert_level=None, max_slots=max_slots,
                 max_seq=max_seq, prefill_budget=prefill_budget, kv_layout="paged",
                 kv_block_size=16, kv_quant=kv_quant, dispatch_mode="fused",
                 use_kernels=True, device=DEVICE)
    if reqs is None:
        reqs = _requests(cfg, n_req, max_new)
    run = _serve(torch, eng, reqs, "decode_step_paged", label, trace=trace)
    kv = eng.kv
    log(f"engine[{label}]: shared_hits={kv.shared_hits} blocks_used_after={kv.blocks_used} "
        f"usage_after={kv.usage()} kv_bytes_used_after={kv.kv_bytes_used()} "
        f"num_free_after={kv.num_free}")
    if (kv.shared_hits <= 0 or kv.blocks_used != 0 or kv.usage() != 0
            or kv.kv_bytes_used() != 0 or kv.num_free != max_slots):
        raise AssertionError(f"engine[{label}]: shared_hits={kv.shared_hits} "
                             f"blocks_used={kv.blocks_used} usage={kv.usage()} "
                             f"kv_bytes_used={kv.kv_bytes_used()} num_free={kv.num_free}")
    want = dict(run["path"], flash_decode_paged=run["seen"]["decode"] * _n_global(cfg),
                flash_decode=0, topk_router=0)
    if run["launches"] != want:
        raise AssertionError(f"engine[{label}]: launches {run['launches']} != path {want}")
    return run


def _n_global(cfg) -> int:
    """Layers that attend over the whole sequence (all but gemma2's local ones)."""
    return sum(not cfg.layer_is_local(i) for i in range(cfg.num_layers))


def _first_kv(cfg, cache):
    """Layer 0's K and V of a GQA slot cache (an interleaved stack's first
    MoE layer), or None for MLA's compressed cache."""
    if cfg.attention_type != "gqa":
        return None
    layers = cache["layers"]
    if "moe" in layers:
        layers = layers["moe"]
    return layers["k"][0], layers["v"][0]


def gimbal_run(torch, cfg, params, *, n_req: int, max_new: int,
               label: str = "slot+gimbal+rep", trace: bool = False,
               variant: str = "gimbal+rep") -> dict:
    """Serve ``n_req`` requests on the slot layout with the ``variant``
    expert level (tau = 8 engine steps, 4 expert devices).  Under
    "gimbal+rep" (R = 4 replica slots, S = E + 4) the level observes the
    routed expert ids, rebalances mid-run, and the backend gathers the
    weights into each new slot map; under "vllm" the placement never moves.

    Checks that every request finished with finite logits, that (under
    "gimbal+rep") experts were relocated into a replicated slot map and the
    router kernel received non-identity replica tables, or (under "vllm")
    nothing was relocated, and that launch counts equal the path's.  Every
    8th decode step, right after it is enqueued, the slot flash-decode
    kernel runs through ``ops.decode_attention`` on layer 0 of the live
    cache (lengths = resident tokens, 0 for free slots; GQA caches only)
    and the identity router kernel through ``ops.route`` on the step's
    router logits; each is held against its plain version there.  Counts
    the physical slots no row reached in each decode-step (T = max_slots)
    routing.  ``trace`` as in ``engine_run``."""
    import numpy as np
    from repro_torch.core.types import GimbalConfig
    from repro_torch.kernels import ops, ref
    from repro_torch.models import moe as moe_lib
    from repro_torch.serving.engine import Engine

    eng = Engine(0, cfg, params, variant=variant, gimbal_cfg=GimbalConfig(tau=8),
                 num_expert_devices=4, kv_layout="slot", dispatch_mode="fused",
                 use_kernels=True, max_slots=8, max_seq=1024, prefill_budget=512,
                 device=DEVICE)
    level = eng.rebalancer
    host = {"observe": 0.0, "tick": 0.0}

    def timed(name, fn):
        def call(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            host[name] += time.perf_counter() - t
            return out
        return call

    level.observe = timed("observe", level.observe)
    level.tick = timed("tick", level.tick)

    tables = {"non_identity": 0, "calls": 0, "checks": 0, "fd_checks": 0,
              "last_logits": None, "last_out": None, "decode_slots": []}
    orig_route = moe_lib.route_replicated

    def route(logits, k, replica_slots, replica_count, num_slots):
        tables["calls"] += 1
        # the initial layout is the identity over E slots; every rebalance
        # of "gimbal+rep" lays out E + R slots, replicas included
        if num_slots > cfg.num_experts:
            tables["non_identity"] += 1
        out = orig_route(logits, k, replica_slots, replica_count, num_slots)
        tables["last_logits"], tables["last_out"] = logits, out
        if logits.shape[0] == eng.max_slots:          # a decode step's T rows
            tables["decode_slots"].append((out[2], num_slots))
        return out

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 4)
    fd_err = [0.0]

    def check_live(eng):
        """Kernels 4 and 5 on the path's own data, every 8th decode step."""
        if tables["checks"] % 8 == 0:
            kv = _first_kv(cfg, eng.kv.cache)
            if kv is not None:
                lengths = torch.as_tensor(eng.kv.slot_len, dtype=torch.int32, device=DEVICE)
                q = torch.randn((eng.max_slots, cfg.num_heads, cfg.head_dim), generator=gen,
                                device=DEVICE).to(cfg.adtype)
                got = ops.decode_attention(q, kv[0], kv[1], lengths)
                want = ref.ref_flash_decode(q, kv[0], kv[1], lengths)
                fd_err[0] = max(fd_err[0], check_close(
                    "flash_decode on the live slot cache", got, want, *FD_TOL[cfg.dtype]))
                if not (got[lengths == 0] == 0).all():
                    raise AssertionError("flash_decode: a free slot's row is not exactly zero")
                tables["fd_checks"] += 1
            logits = tables["last_logits"]          # the step's last MoE layer
            gates, ids, pos = ops.route(logits, cfg.moe_top_k)
            want = ref.ref_topk_router(logits, cfg.moe_top_k)
            check_close("topk_router on the step's router logits", gates, want[0], 1e-5)
            if not (torch.equal(ids, want[1]) and torch.equal(pos, want[2])
                    and torch.equal(ids, tables["last_out"][1])):
                raise AssertionError("topk_router: ids or positions differ on the path's logits")
        tables["checks"] += 1

    moe_lib.route_replicated = route
    try:
        run = _serve(torch, eng, _requests(cfg, n_req, max_new), "decode_step", label,
                     trace=trace, after_decode=check_live)
    finally:
        moe_lib.route_replicated = orig_route
    slot_map = None if level.slot_map is None else np.asarray(level.slot_map)
    copies = int(level.placement().replica_count.max())
    n_checks = -(-tables["checks"] // 8)
    empty = [n - int(torch.unique(sl).numel()) for sl, n in tables["decode_slots"]]
    log(f"engine[{label}]: relocations={eng.relocations} "
        f"rebalances={level.migrations} slots={cfg.num_experts if slot_map is None else len(slot_map)} "
        f"max_copies={copies} "
        f"router_calls_with_replica_tables={tables['non_identity']}/{tables['calls']} "
        f"live_checks={n_checks} flash_decode_live_checks={tables['fd_checks']} "
        f"flash_decode_live_max_abs_err={fd_err[0]:.3e} "
        f"host_observe_s={host['observe']:.4f} host_tick_s={host['tick']:.4f} "
        f"moe_mult={level.moe_mult:.4f} cross_frac={level.cross_frac:.4f}")
    if empty:
        log(f"engine[{label}]: slots no row reached at T={eng.max_slots} (k={cfg.moe_top_k}), "
            f"over {len(empty)} decode-step routings: mean={statistics.mean(empty):.2f} "
            f"min={min(empty)} max={max(empty)} of {tables['decode_slots'][-1][1]} slots")
    for ev in level.events:
        log(f"engine[{label}] rebalance: step={ev.step} moved_experts="
            f"{ev.moved_experts} bytes_moved={ev.bytes_moved} imbalance "
            f"{ev.imbalance_before:.4f} -> {ev.imbalance_after:.4f} cut "
            f"{ev.cut_before:.1f} -> {ev.cut_after:.1f}")
    if variant == "gimbal+rep":
        if eng.relocations < 1:
            raise AssertionError(f"engine[{label}]: no relocation fired")
        if slot_map is None or len(slot_map) != cfg.num_experts + 4 or copies < 2:
            raise AssertionError(f"engine[{label}]: slot map {slot_map}, at most {copies} "
                                 f"copies of an expert")
        if tables["non_identity"] < 1:
            raise AssertionError(f"engine[{label}]: the router never received "
                                 "replica tables")
    elif eng.relocations or tables["non_identity"]:
        raise AssertionError(f"engine[{label}]: {variant} relocated experts "
                             f"({eng.relocations}) or replicated them")
    want = dict(run["path"], flash_decode_paged=0, flash_decode=tables["fd_checks"],
                topk_router=n_checks)
    if run["launches"] != want:
        raise AssertionError(f"engine[{label}]: launches {run['launches']} "
                             f"!= path {want}")
    return run


# ----------------------------------------------------------------------------- cluster

CLUSTER_KW = dict(max_slots=8, max_seq=1024, prefill_budget=512, dispatch_mode="fused",
                  use_kernels=True)
PAGED_KW = dict(CLUSTER_KW, kv_layout="paged", kv_block_size=16, expert_level=None)


def _cluster_trace(cfg) -> list:
    """The cluster runs' traffic: 24 ShareGPT-style turns of 6 users at 8
    requests a second (a user's turn extends their transcript, so sessions
    share real prefixes), prompts whole, generated lengths folded to at
    most 32 tokens."""
    from repro_torch.workloads import sharegpt_trace

    trace = sharegpt_trace(n_requests=24, n_users=6, rps=8.0, seed=SEED,
                           vocab_size=cfg.vocab_size, utterance_mean=60, answer_mean=24,
                           max_context=768)
    for r in trace:
        r.max_new_tokens = min(r.max_new_tokens, 32)
    return trace


def _drive_cluster(torch, cl, reqs, drill, label: str) -> dict:
    """Drive ``cl`` through ``run_drill(drill, dt=0.05)`` on the logical
    clock, with every kernel's count set to 0 just before and read just
    after.  Per engine: its prefill and decode calls, the kernel launches
    made inside them and each request's greedy tokens; every logit is
    checked finite.  Checks that every request finished or was shed and
    that each engine's launches equal its path's."""
    from collections import Counter

    from repro_torch import kernels as K
    from repro_torch.distributed.drill import run_drill
    from repro_torch.models import model as M

    def counts():
        return {fn.__name__: fn.launches for fn in K.KERNELS}

    per, tokens, finite = {}, {}, [True]

    def wrap(eng):
        st = per.setdefault(eng.engine_id, {"prefill": 0, "decode": 0,
                                            "launches": dict.fromkeys(counts(), 0)})
        b = eng.backend
        orig_start, orig_decode = b.start, b.decode

        def charge(kind, fn, *a):
            before = counts()
            out = fn(*a)
            st[kind] += 1
            for k, v in counts().items():
                st["launches"][k] += v - before[k]
            return out

        def start(r, now):
            out = charge("prefill", orig_start, r, now)
            tokens.setdefault(r.req_id, []).append(int(b.slot_last_token[out[0]]))
            return out

        def decode(active, now):
            out = charge("decode", orig_decode, active, now)
            for slot, r in active:
                tokens.setdefault(r.req_id, []).append(int(b.slot_last_token[slot]))
            return out

        b.start, b.decode = start, decode

    for eng in cl.engines.values():
        wrap(eng)
    originals = {n: getattr(M, n) for n in ("prefill", "decode_step", "decode_step_paged")}

    def checked(fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            finite[0] &= bool(out[0].isfinite().all())
            return out
        return call

    steps = [0]
    orig_step = cl.step

    def step(now):
        steps[0] += 1
        return orig_step(now)

    cl.step = step
    for n, fn in originals.items():
        setattr(M, n, checked(fn))
    try:
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        runner = run_drill(cl, reqs, drill, dt=0.05)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts()
    finally:
        for n, fn in originals.items():
            setattr(M, n, fn)

    shed = cl.shed_requests()
    gen = sum(r.generated for r in cl.finished)
    done_by = Counter(r.engine_id for r in cl.finished)
    sent_to = Counter(e for _, e in cl.dispatch.assignment_log())
    log(f"cluster[{label}]: requests finished={len(cl.finished)} shed={len(shed)} "
        f"of {len(reqs)} wall_s={wall:.3f} cluster_steps={steps[0]} "
        f"wall_ms_per_cluster_step={1e3 * wall / max(steps[0], 1):.3f} "
        f"generated_tokens={gen} generated_tokens_per_wall_s={gen / wall:.2f} "
        f"finished_per_engine={dict(sorted(done_by.items()))} "
        f"assignments_per_engine={dict(sorted(sent_to.items()))} launches={launches}")
    for eid, st in sorted(per.items()):
        log(f"cluster[{label}] engine {eid}: prefills={st['prefill']} "
            f"decode_steps={st['decode']} launches={st['launches']}")
    rep = cl.report()
    log(f"cluster[{label}] report, logical-clock seconds (dt 0.05 a step): "
        f"mean_ttft={rep.mean_ttft:.3f} p99_ttft={rep.p99_ttft:.3f} "
        f"mean_tpot={rep.mean_tpot:.4f} prefix={cl.prefix_stats()}")
    if not finite[0]:
        raise AssertionError(f"cluster[{label}]: non-finite logits")
    if len(cl.finished) + len(shed) != len(reqs):
        raise AssertionError(f"cluster[{label}]: {len(cl.finished)} finished + "
                             f"{len(shed)} shed != {len(reqs)}")
    for eid, st in per.items():
        eng = cl.engines[eid]
        L, n = eng.cfg.num_layers, st["prefill"] + st["decode"]
        paged = eng.backend.kv_layout == "paged"
        want = {"flash_decode_paged": st["decode"] * L if paged else 0,
                "topk_router_replicated": n * L, "moe_gemm": 3 * n * L,
                "flash_decode": 0, "topk_router": 0}
        if st["launches"] != want:
            raise AssertionError(f"cluster[{label}] engine {eid}: launches "
                                 f"{st['launches']} != path {want}")
    total = {k: sum(st["launches"][k] for st in per.values()) for k in launches}
    if total != launches:
        raise AssertionError(f"cluster[{label}]: launches outside the engines' calls "
                             f"{launches} != {total}")
    return dict(launches=launches, runner=runner, tokens=tokens, wall=wall,
                steps=steps[0])


def cluster_kill_migrate(torch, cfg, params, trace) -> dict:
    """C1: two unified paged engines (no expert level) behind "combined"
    scored dispatch, under the "kill_migrate" drill: engine 1 is failed
    over with its KV migrated at a quarter of the arrival window and
    restored at 60 %."""
    from repro_torch.serving.cluster import Cluster
    from repro_torch.serving.engine import Engine

    engines = [Engine(i, cfg, params, variant="combined", device=DEVICE, **PAGED_KW)
               for i in range(2)]
    cl = Cluster(engines, variant="combined")
    run = _drive_cluster(torch, cl, copy.deepcopy(trace), "kill_migrate", "C1 kill_migrate")
    life = cl.dispatch.lifecycle_log()
    hits = cl.prefix_stats()["hit_blocks"]
    used = {eid: e.kv.blocks_used for eid, e in cl.engines.items()}
    log(f"cluster[C1]: lifecycle={life} fired={[(a, e) for _, a, e in run['runner'].fired]} "
        f"rerouted={cl.rerouted} prefix_hit_blocks={hits} "
        f"shared_pages={[e.kv.shared_hits for e in engines]} blocks_used_after={used}")
    if ("fail:migrated", 1) not in life or ("restore", 1) not in life:
        raise AssertionError(f"cluster[C1]: lifecycle {life} lacks the drill's fail and restore")
    if cl.rerouted <= 0:
        raise AssertionError("cluster[C1]: the kill re-routed nothing")
    if hits <= 0 or any(used.values()):
        raise AssertionError(f"cluster[C1]: prefix hit blocks {hits}, pages left {used}")
    return run


def cluster_disaggregated(torch, cfg, params, trace) -> dict:
    """C2: one prefill and one decode paged engine under "combined": every
    request prefills on engine 0 and is handed off, KV and all, to engine
    1, which decodes it to the end."""
    from collections import Counter

    from repro_torch.serving.cluster import Cluster
    from repro_torch.serving.engine import Engine

    engines = [Engine(i, cfg, params, variant="combined", role=role, device=DEVICE,
                      **PAGED_KW)
               for i, role in enumerate(("prefill", "decode"))]
    cl = Cluster(engines, variant="combined")
    reqs = copy.deepcopy(trace[:12])
    run = _drive_cluster(torch, cl, reqs, "none", "C2 1P+1D")
    xfer = cl.kv_transfer_log()
    kinds = [k for k, _, _ in engines[0].core.event_log()]
    log(f"cluster[C2]: kv_transfers={len(xfer)} handoffs={kinds.count('handoff')} "
        f"finished_on={sorted({r.engine_id for r in cl.finished})}")
    if sorted(xfer) != sorted((r.req_id, 0, 1) for r in reqs):
        raise AssertionError(f"cluster[C2]: kv_transfer_log {xfer} is not one (req, 0, 1) "
                             "per request")
    if any(r.engine_id != 1 for r in cl.finished) or len(cl.finished) != len(reqs):
        raise AssertionError("cluster[C2]: a request did not finish on the decode engine")
    if kinds.count("handoff") != len(reqs) or "finish" in kinds:
        raise AssertionError(f"cluster[C2]: prefill engine events {dict(Counter(kinds))}")
    return run


def cluster_shared_level(torch, cfg, params, trace, label: str) -> dict:
    """C3: two unified slot-layout engines sharing one "gimbal+rep" expert
    level over 4 expert devices (R = 4, S = 132; tau 8 aggregate engine
    steps) seeded with the synthetic prior (seed 0, hot boost 8), "gimbal"
    dispatch.  Records the expert ids the level observed and its rebalance
    events; checks that it rebalanced, that the router kernel received
    132-slot tables, and that both engines apply the level's slot map."""
    import numpy as np
    from repro_torch.core.gimbal import make_cluster_expert_level
    from repro_torch.core.types import GimbalConfig
    from repro_torch.models import moe as moe_lib
    from repro_torch.serving.cluster import Cluster
    from repro_torch.serving.engine import Engine

    gcfg = GimbalConfig(tau=8)
    level = make_cluster_expert_level("gimbal+rep", cfg, 4, gcfg, prior_seed=0,
                                      hot_boost=8.0)
    engines = [Engine(i, cfg, params, variant="gimbal", gimbal_cfg=gcfg, expert_level=level,
                      kv_layout="slot", device=DEVICE, **CLUSTER_KW) for i in range(2)]
    cl = Cluster(engines, variant="gimbal", gimbal_cfg=gcfg, expert_level=level)
    observed = []
    orig_observe = level.observe

    def observe(expert_ids):
        observed.append(np.array(expert_ids, copy=True))
        return orig_observe(expert_ids)

    level.observe = observe
    slots_seen = {}
    orig_route = moe_lib.route_replicated

    def route(logits, k, replica_slots, replica_count, num_slots):
        slots_seen[num_slots] = slots_seen.get(num_slots, 0) + 1
        return orig_route(logits, k, replica_slots, replica_count, num_slots)

    moe_lib.route_replicated = route
    try:
        run = _drive_cluster(torch, cl, copy.deepcopy(trace[:16]), "none", label)
    finally:
        moe_lib.route_replicated = orig_route
    for e in engines:
        e.backend._sync_placement()
    slot_map = np.asarray(level.slot_map)
    log(f"cluster[{label}]: rebalances={len(level.events)} slots={len(slot_map)} "
        f"max_copies={int(level.placement().replica_count.max())} "
        f"relocations={[e.relocations for e in engines]} router_calls_by_slots="
        f"{dict(sorted(slots_seen.items()))} observed_batches={len(observed)}")
    if not level.events:
        raise AssertionError(f"cluster[{label}]: no rebalance event")
    if len(slot_map) != cfg.num_experts + 4 or slots_seen.get(cfg.num_experts + 4, 0) < 1:
        raise AssertionError(f"cluster[{label}]: the router never received "
                             f"{cfg.num_experts + 4}-slot tables")
    for e in engines:
        if not np.array_equal(e.backend._applied_map, slot_map):
            raise AssertionError(f"cluster[{label}]: engine {e.engine_id} applies another "
                                 "slot map than the level's")
    run.update(observed=observed, events=[vars(ev) for ev in level.events])
    return run


def _same_runs(a: dict, b: dict) -> None:
    """C3's reproducibility gate: the greedy tokens of every request, the
    expert ids the level observed and its rebalance events are identical."""
    import numpy as np
    if a["tokens"] != b["tokens"]:
        bad = sorted(r for r in set(a["tokens"]) | set(b["tokens"])
                     if a["tokens"].get(r) != b["tokens"].get(r))
        raise AssertionError(f"cluster[C3]: greedy tokens differ between runs for "
                             f"requests {bad}")
    if len(a["observed"]) != len(b["observed"]) or not all(
            np.array_equal(x, y) for x, y in zip(a["observed"], b["observed"])):
        first = next((i for i, (x, y) in enumerate(zip(a["observed"], b["observed"]))
                      if not np.array_equal(x, y)), None)
        raise AssertionError(f"cluster[C3]: observed expert ids differ between runs "
                             f"(batches {len(a['observed'])} / {len(b['observed'])}, "
                             f"first differing {first})")
    if a["events"] != b["events"]:
        raise AssertionError(f"cluster[C3]: rebalance events differ: {a['events']} vs "
                             f"{b['events']}")
    log(f"cluster[C3]: two runs identical: {len(a['tokens'])} requests' greedy tokens "
        f"({sum(len(t) for t in a['tokens'].values())} tokens), "
        f"{len(a['observed'])} observed expert-id batches, "
        f"{len(a['events'])} rebalance events")


def cluster_phase(torch, cfg, params) -> dict:
    """C1-C3 over one ShareGPT-style trace; C3 runs twice from fresh state
    and must repeat itself exactly.  Returns each run's kernel launches."""
    trace = _cluster_trace(cfg)
    log(f"cluster trace: {len(trace)} requests, users {len({r.user_id for r in trace})}, "
        f"prompt tokens {sum(r.prompt_len for r in trace)} "
        f"(max {max(r.prompt_len for r in trace)}), new tokens "
        f"{sum(r.max_new_tokens for r in trace)}, arrivals over "
        f"{trace[-1].arrival_time:.3f} logical s")
    c1 = cluster_kill_migrate(torch, cfg, params, trace)
    c2 = cluster_disaggregated(torch, cfg, params, trace)
    c3 = cluster_shared_level(torch, cfg, params, trace, "C3 shared level")
    c3b = cluster_shared_level(torch, cfg, params, trace, "C3 shared level, repeat")
    _same_runs(c3, c3b)
    return {"C1": c1["launches"], "C2": c2["launches"], "C3": c3["launches"],
            "C3 repeat": c3b["launches"]}


# ----------------------------------------------------------------------------- families

# (arch, layers kept) of the families phase's reduced runs: full width, depth
# cut because 80 / 52 / 40 / 48 layers are ~145 / ~56 / ~16 / ~40 GB of bf16
# weights and depth changes no kernel shape
FAMILY_DEPTHS = (("qwen2-72b", 4), ("granite-20b", 4), ("granite-3-8b", 4))


def _family_params(torch, cfg, label: str):
    from repro_torch.models import model as M
    from repro_torch.tree import leaves
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=SEED, device=DEVICE)
    torch.cuda.synchronize()
    extra = ""
    if cfg.is_moe:
        extra += (f" experts={cfg.num_experts} top{cfg.moe_top_k} shared="
                  f"{cfg.num_shared_experts} moe_d_ff={cfg.moe_d_ff} moe_layers="
                  f"{cfg.num_moe_layers()} first_k_dense={cfg.first_k_dense} "
                  f"moe_every={cfg.moe_every}")
    if cfg.attention_type == "mla":
        extra += (f" mla q/kv ranks={cfg.q_lora_rank}/{cfg.kv_lora_rank} "
                  f"nope/rope/v={cfg.qk_nope_head_dim}/{cfg.qk_rope_head_dim}/{cfg.v_head_dim}")
    if cfg.is_encoder_decoder:
        extra += (f" encoder_layers={cfg.num_encoder_layers} "
                  f"encoder_len={cfg.encoder_len}")
    if cfg.ssm_state:
        extra += (f" ssm d_inner={cfg.ssm_d_inner} heads={cfg.ssm_heads}x{cfg.ssm_head_dim} "
                  f"state={cfg.ssm_state} conv={cfg.ssm_conv} chunk={cfg.ssm_chunk} "
                  f"shared_attn_every={cfg.shared_attn_every}")
    log(f"family[{label}]: {cfg.num_layers} layers, d_model={cfg.d_model} heads="
        f"{cfg.num_heads}/{cfg.num_kv_heads}x{cfg.head_dim} d_ff={cfg.d_ff} vocab="
        f"{cfg.vocab_size} qkv_bias={cfg.qkv_bias} softcaps={cfg.attn_logit_softcap}/"
        f"{cfg.final_logit_softcap} window={cfg.sliding_window} global_layers="
        f"{_n_global(cfg)}{extra}: {sum(p.numel() for p in leaves(params)) / 1e9:.3f} B "
        f"parameters, init {time.perf_counter() - t0:.3f} s, device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return params


def _free(torch) -> None:
    """Release what the last run left: the engines' wrapped methods form
    reference cycles, which hold device memory until a collection."""
    gc.collect()
    torch.cuda.empty_cache()


def _family_engine(torch, cfg, params, label: str, reqs, **engine_kw) -> dict:
    """One paged Engine run of a dense family (kernel 1 on the global
    layers, nothing else launched), with its peak device memory."""
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    run = engine_run(torch, cfg, params, n_req=len(reqs), max_new=0, kv_quant=None,
                     label=label, reqs=reqs, **engine_kw)
    log(f"engine[{label}]: peak_device_memory_gib="
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    return run["launches"]


def _vlm_run(torch, cfg, params, label: str) -> dict:
    """internvl2's language model: four rows prefilled with a 256-position
    vision prefix (seeded stand-ins for the stub frontend's embeddings)
    ahead of 128-511 prompt tokens into a slot cache, then 8 slot decode
    steps of all rows; logits finite and of the prefix-covering shape.
    Kernel 4 is held against its plain version on layer 0 and the last
    layer of the run's own cache after the last step (those launches are
    the run's count: the slot path's attention is plain)."""
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.kernels import ops, ref
    from repro_torch.models import model as M
    from repro_torch.serving.kvcache import SlotKVCache, write_slot

    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 5)
    rng = np.random.default_rng(SEED)
    n_rows, max_seq, p = 4, 1024, cfg.vision_prefix_len
    kv = SlotKVCache(cfg, n_rows, max_seq, device=DEVICE)
    tokens = torch.zeros((n_rows, 1), dtype=torch.long, device=DEVICE)
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for row, plen in enumerate((128, 300, 511, 200)):
            toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, plen)), device=DEVICE)
            vis = torch.randn((1, p, cfg.d_model), generator=gen, device=DEVICE)
            cache = M.init_cache(cfg, 1, p + plen, device=DEVICE)
            logits, cache, _ = M.prefill(params, cfg, toks, cache, vision_embeds=vis)
            if tuple(logits.shape) != (1, p + plen, cfg.vocab_size) \
                    or not bool(logits.isfinite().all()):
                raise AssertionError(f"vlm[{label}]: prefill logits {tuple(logits.shape)}, "
                                     "not the prefix-covering shape or not finite")
            slot = kv.alloc()
            write_slot(kv.cache, cache, slot, kv.write_axes)
            kv.slot_len[slot] = p + plen
            tokens[slot, 0] = int(torch.argmax(logits[0, -1]))
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        t1 = time.perf_counter()
        for _ in range(8):
            logits, _, _ = M.decode_step(params, cfg, tokens, kv.cache, kv.positions())
            if not bool(logits.isfinite().all()):
                raise AssertionError(f"vlm[{label}]: non-finite decode logits")
            tokens = torch.argmax(logits, -1)[:, None]
            kv.slot_len += 1
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t1
        path = {fn.__name__: fn.launches for fn in K.KERNELS}
        if any(path.values()):
            raise AssertionError(f"vlm[{label}]: the plain slot path launched {path}")
        lengths = torch.as_tensor(kv.slot_len, dtype=torch.int32, device=DEVICE)
        err = 0.0
        for layer in (0, cfg.num_layers - 1):
            ck, cv = kv.cache["layers"]["k"][layer], kv.cache["layers"]["v"][layer]
            q = torch.randn((n_rows, cfg.num_heads, cfg.head_dim), generator=gen,
                            device=DEVICE).to(cfg.adtype)
            err = max(err, check_close(f"flash_decode on {label}'s slot cache",
                                       ops.decode_attention(q, ck, cv, lengths),
                                       ref.ref_flash_decode(q, ck, cv, lengths),
                                       *FD_TOL[cfg.dtype]))
    launches = {fn.__name__: fn.launches for fn in K.KERNELS}
    wall = t_prefill + t_decode
    log(f"vlm[{label}]: rows={n_rows} vision_prefix={p} prompt_tokens={[128, 300, 511, 200]} "
        f"resident={kv.slot_len.tolist()} prefill_s={t_prefill:.3f} decode_steps=8 "
        f"ms_per_decode_step={1e3 * t_decode / 8:.3f} generated_tokens_per_s="
        f"{8 * n_rows / t_decode:.2f} wall_s={wall:.3f} flash_decode_on_cache_max_abs_err="
        f"{err:.3e} launches={launches} peak_device_memory_gib="
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    return launches


def families_phase(torch) -> dict:
    """The dense GQA families at full width: gemma2-2b at full depth (an f32
    decode step of 2 layers, kernels against the plain path; 8 requests; 2
    prompts past the 4096 window), then qwen2-72b, granite-20b and
    granite-3-8b at 4 layers (8 requests each) and internvl2's language
    model at 4 layers with its vision prefix; a short traced gemma2 run
    gives the device's busy share.  Each model is freed before the next.
    Returns each run's kernel launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    _free(torch)
    log(f"families phase: device memory held on entry "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    runs = {}
    cfg = get_config("gemma2-2b")
    cfg32 = cfg.replace(num_layers=2, dtype="float32")
    params = M.init_params(cfg32, seed=SEED + 1, device=DEVICE)
    _paged_step_vs_plain(torch, cfg32, params, "[gemma2-2b, 2 layers]")
    del params
    _free(torch)
    params = _family_params(torch, cfg, "gemma2-2b")
    runs["gemma2-2b"] = _family_engine(torch, cfg, params, "gemma2-2b",
                                       _requests(cfg, 8, 32))
    runs["gemma2-2b past the window"] = _family_engine(
        torch, cfg, params, "gemma2-2b past the window",
        _requests(cfg, 2, 16, lo=4200, hi=4400, prefix_len=2048, share_every=1),
        max_slots=2, max_seq=4864, prefill_budget=4864)
    # a short traced window: the profiler's own processing grows with the
    # events of 26 layers a step
    runs["gemma2-2b traced"] = _retraced(lambda **kw: _family_engine(
        torch, cfg, params, "gemma2-2b traced", _requests(cfg, 4, 8), **kw))
    del params
    for arch, depth in FAMILY_DEPTHS:
        cfg = get_config(arch).replace(num_layers=depth)
        params = _family_params(torch, cfg, arch)
        runs[arch] = _family_engine(torch, cfg, params, arch, _requests(cfg, 8, 32))
        del params
    cfg = get_config("internvl2-26b").replace(num_layers=4)
    params = _family_params(torch, cfg, "internvl2-26b")
    runs["internvl2-26b"] = _vlm_run(torch, cfg, params, "internvl2-26b")
    del params
    _free(torch)
    log(f"families phase: {time.perf_counter() - t0:.1f} s")
    return runs


# ----------------------------------------------------------------------------- variants

DEEPSEEK, LLAMA4, WHISPER = ("deepseek-v2-236b", "llama4-maverick-400b-a17b",
                             "whisper-medium")
# (arch, layers kept) of the variants phase: full width, depth cut because
# 60 / 48 layers are ~472 / ~800 GB of bf16 weights (one llama4 MoE layer
# holds 32.2 GB of experts, deepseek's 7.55 GB); depth changes no kernel
# shape.  deepseek keeps its dense prologue layer and 3 MoE layers, llama4
# one super-block (1 MoE + 1 dense layer)
VARIANT_DEPTHS = ((DEEPSEEK, 4), (LLAMA4, 2))


def _slot_engine(torch, cfg, params, label: str, variant: str, **kw) -> dict:
    """One slot-layout ``gimbal_run`` with its peak device memory."""
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    run = gimbal_run(torch, cfg, params, label=label, variant=variant, **kw)
    log(f"engine[{label}]: peak_device_memory_gib="
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    return run["launches"]


def _whisper_run(torch, cfg, params, label: str) -> dict:
    """whisper at full depth through the model entry points (the reference
    ``Engine`` passes no frames): seeded (8, enc_len, d) frame embeddings
    stand in for the stub frontend; each row's prompt of 16-64 tokens is
    prefilled with its frames (encoder, then decoder) into a slot cache with
    its encoder memory, then 32 slot ``decode_step``s of all rows.  Logits
    must be finite and of the expected shapes, and no kernel launches (the
    encoder-decoder path is plain PyTorch, as in the reference)."""
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.models import model as M
    from repro_torch.serving.kvcache import SlotKVCache, write_slot

    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 6)
    rng = np.random.default_rng(SEED)
    n_rows, max_seq, steps = 8, 128, 32
    frames = torch.randn((n_rows, cfg.encoder_len, cfg.d_model), generator=gen, device=DEVICE)
    plens = [int(x) for x in rng.integers(16, 65, n_rows)]
    kv = SlotKVCache(cfg, n_rows, max_seq, device=DEVICE)
    tokens = torch.zeros((n_rows, 1), dtype=torch.long, device=DEVICE)
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for row, plen in enumerate(plens):
            toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, plen)), device=DEVICE)
            cache = M.init_cache(cfg, 1, plen, device=DEVICE)
            logits, cache, _ = M.prefill(params, cfg, toks, cache, frames=frames[row:row + 1])
            if tuple(logits.shape) != (1, plen, cfg.vocab_size) \
                    or tuple(cache["memory"].shape) != (1, cfg.encoder_len, cfg.d_model) \
                    or not bool(logits.isfinite().all()):
                raise AssertionError(f"whisper[{label}]: prefill logits {tuple(logits.shape)} "
                                     "or memory not of the expected shape, or not finite")
            slot = kv.alloc()
            write_slot(kv.cache, cache, slot, kv.write_axes)
            kv.slot_len[slot] = plen
            tokens[slot, 0] = int(torch.argmax(logits[0, -1]))
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        t1 = time.perf_counter()
        for _ in range(steps):
            logits, _, _ = M.decode_step(params, cfg, tokens, kv.cache, kv.positions())
            if tuple(logits.shape) != (n_rows, cfg.vocab_size) \
                    or not bool(logits.isfinite().all()):
                raise AssertionError(f"whisper[{label}]: decode logits "
                                     f"{tuple(logits.shape)} or not finite")
            tokens = torch.argmax(logits, -1)[:, None]
            kv.slot_len += 1
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t1
    launches = {fn.__name__: fn.launches for fn in K.KERNELS}
    if any(launches.values()):
        raise AssertionError(f"whisper[{label}]: the plain path launched {launches}")
    log(f"whisper[{label}]: rows={n_rows} frames={tuple(frames.shape)} prompt_tokens={plens} "
        f"resident={kv.slot_len.tolist()} prefill_s={t_prefill:.3f} "
        f"({1e3 * t_prefill / n_rows:.3f} ms a row: encoder + decoder) decode_steps={steps} "
        f"ms_per_decode_step={1e3 * t_decode / steps:.3f} generated_tokens_per_s="
        f"{steps * n_rows / t_decode:.2f} wall_s={t_prefill + t_decode:.3f} "
        f"launches={launches} peak_device_memory_gib="
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    return launches


def variants_phase(torch) -> dict:
    """The MoE variants and the encoder-decoder at full width, random bf16
    weights from seed 0, each model freed before the next: deepseek-v2 (an
    f32 decode step of 2 layers, 1 dense + 1 MoE, under a replicated
    placement, kernels against the plain path and MLA absorbed against
    naive; then an ``Engine`` run at 4 layers under "gimbal+rep" and a short
    traced one), llama4 at 2 layers (one bf16 decode step, kernels against
    the plain path; then an ``Engine`` run under "vllm", kernel 4 checked on
    its slot cache, and a short traced one), whisper-medium at full depth
    (``prefill(frames=)`` and 32 decode steps).  Returns each run's kernel
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    _free(torch)
    log(f"variants phase: device memory held on entry "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    runs = {}
    depth = dict(VARIANT_DEPTHS)
    cfg = get_config(DEEPSEEK)
    cfg32 = cfg.replace(num_layers=2, dtype="float32")
    params = M.init_params(cfg32, seed=SEED + 1, device=DEVICE)
    _replicated_slot_step(torch, cfg32, params, f"[{DEEPSEEK}, 2 layers]")
    del params
    _free(torch)
    for arch, variant in ((DEEPSEEK, "gimbal+rep"), (LLAMA4, "vllm")):
        cfg = get_config(arch).replace(num_layers=depth[arch])
        log(f"variant[{arch}]: reduced: num_layers {get_config(arch).num_layers} -> "
            f"{depth[arch]}")
        params = _family_params(torch, cfg, arch)
        if arch == LLAMA4:
            _replicated_slot_step(torch, cfg, params, f"[{arch}, {depth[arch]} layers]",
                                  replicate=False)
        runs[arch] = _slot_engine(torch, cfg, params, f"{arch} slot+{variant}", variant,
                                  n_req=16, max_new=32)
        runs[f"{arch} traced"] = _retraced(lambda **kw: _slot_engine(
            torch, cfg, params, f"{arch} slot+{variant} traced", variant, n_req=8,
            max_new=16, **kw))
        del params
        _free(torch)
    cfg = get_config(WHISPER)
    params = _family_params(torch, cfg, WHISPER)
    runs[WHISPER] = _whisper_run(torch, cfg, params, WHISPER)
    del params
    _free(torch)
    log(f"variants phase: {time.perf_counter() - t0:.1f} s")
    return runs


# ----------------------------------------------------------------------------- ssm

MAMBA2, ZAMBA2 = "mamba2-370m", "zamba2-1.2b"
# the f32 gates' models: full width, shallow depth; zamba2 keeps one
# super-block (the shared attention block, then 2 mamba layers) and one
# epilogue mamba layer
SSM_GATE_CUTS = ((MAMBA2, dict(num_layers=2)),
                 (ZAMBA2, dict(num_layers=3, shared_attn_every=2)))
SSM_GATE_PROMPT, SSM_GATE_STEPS = 300, 4    # two 256-token chunks, the second ragged
SSM_LONG_ROW = 16383                        # bucket 16384: 64 chunks of 256
SSM_LONG_STEPS = 32                         # decode steps after it, inside max_seq


def _ssm_forced(torch, cfg, params, toks, n: int, device):
    """Prefill ``toks[:n]`` unpadded into a fresh cache on ``device``, then
    decode ``toks[n:]`` one token a step (teacher-forced).  Returns (the
    prefill's logits (n, V), the decode steps' logits (len - n, V) or None
    when there is none)."""
    from repro_torch.models import model as M

    t = torch.as_tensor(toks, device=device)[None]
    cache = M.init_cache(cfg, 1, t.shape[1], device=device)
    steps = []
    with torch.no_grad():
        logits, _, _ = M.prefill(params, cfg, t[:, :n], cache)
        for i in range(n, t.shape[1]):
            pos = torch.tensor([i], dtype=torch.int32, device=device)
            steps.append(M.decode_step(params, cfg, t[:, i:i + 1], cache, pos)[0][0])
    return logits[0], torch.stack(steps) if steps else None


def _ssm_decode_faults() -> dict:
    """Two wrong Mamba2 decode steps, each the port's own step with one
    fault: the new state written into a copy (the cache keeps the old one),
    and the conv tail read as zeros."""
    from repro_torch.models import mamba2 as m2
    step = m2.mamba2_decode

    def state_not_written(params, cfg, u, cache):
        out, _ = step(params, cfg, u, dict(cache, ssm=cache["ssm"].clone()))
        return out, cache

    def conv_tail_zeros(params, cfg, u, cache):
        cache["conv"].zero_()
        return step(params, cfg, u, cache)

    return {"state not written back": state_not_written,
            "conv tail read as zeros": conv_tail_zeros}


def _ssm_gates(torch, cfg32, params, label: str) -> dict:
    """The two f32 gates of an SSM or hybrid model at full width: (a) the
    card against the CPU on the same weights, a ``SSM_GATE_PROMPT``-token
    prefill and ``SSM_GATE_STEPS`` decode steps, logits within ``TOL``;
    (b) chunked against recurrent on the card, each decode step's logits
    against an unpadded prefill of all the tokens at that position, within
    ``TOL``, and each of ``_ssm_decode_faults`` outside it.  Returns
    {gate: max abs err}."""
    import numpy as np
    from repro_torch.models import mamba2 as m2
    from repro_torch.tree import map_tree

    n = SSM_GATE_PROMPT
    toks = np.random.default_rng(SEED + 7).integers(0, cfg32.vocab_size, n + SSM_GATE_STEPS)
    tol = TOL["float32"]
    pre, dec = _ssm_forced(torch, cfg32, params, toks, n, DEVICE)
    cpu_pre, cpu_dec = _ssm_forced(torch, cfg32, map_tree(lambda t: t.cpu(), params), toks,
                                   n, "cpu")
    errs = {"card vs cpu": max(
        check_close(f"ssm{label}: prefill logits, card vs CPU", pre.cpu(), cpu_pre, tol),
        check_close(f"ssm{label}: decode logits, card vs CPU", dec.cpu(), cpu_dec, tol))}
    want = _ssm_forced(torch, cfg32, params, toks, len(toks), DEVICE)[0][n:]
    errs["recurrent vs chunked"] = check_close(
        f"ssm{label}: decode logits against the chunked prefill's", dec, want, tol)
    step, faults = m2.mamba2_decode, {}
    try:
        for fault, wrong in _ssm_decode_faults().items():
            m2.mamba2_decode = wrong
            faults[fault] = max_excess(_ssm_forced(torch, cfg32, params, toks, n, DEVICE)[1],
                                       want, tol, tol)
    finally:
        m2.mamba2_decode = step
    for fault, (_, excess) in faults.items():
        if excess <= 0:
            raise AssertionError(f"ssm{label}: the recurrent gate cannot tell {fault!r} "
                                 f"from the chunked prefill")
    log(f"ssm{label}: f32, prompt {n} + {SSM_GATE_STEPS} decode steps: card vs CPU "
        f"max_abs_err={errs['card vs cpu']:.3e}, decode vs chunked prefill max_abs_err="
        f"{errs['recurrent vs chunked']:.3e} (rtol = atol = {tol}); faults outside the "
        f"gate: " + ", ".join(f"{f} (max abs err {e:.3e})" for f, (e, _) in faults.items()))
    return errs


def _ssm_engine(torch, cfg, params, label: str, reqs, *, trace: bool = False,
                max_seq: int = 1024, prefill_budget: int = 512) -> dict:
    """One slot-layout ``Engine`` run of an SSM or hybrid model (no expert
    level, 8 slots) through ``_serve``.  Checks that the cache keeps the
    state in bf16 and, every 8th decode step right after it is enqueued,
    that ``usage()`` is occupied slots over slots for a model without
    attention and resident tokens over capacity otherwise; for a hybrid,
    kernel 4 runs there on super-block 0's shared-attention KV cache
    (lengths = resident tokens, 0 for free slots) against its plain
    version, and the inputs of the check with the most resident tokens are
    kept.  Launch counts must equal the path's:
    the slot path attends in plain PyTorch, so only those checks launch.
    Returns ``_serve``'s dict with the snapshot, the slot cache's bytes and
    the peak device memory."""
    from repro_torch.kernels import ops, ref
    from repro_torch.serving.engine import Engine
    from repro_torch.tree import leaves

    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(0, cfg, params, variant="gimbal", expert_level=None, max_slots=8,
                 max_seq=max_seq, prefill_budget=prefill_budget, kv_layout="slot",
                 device=DEVICE)
    state = eng.kv.cache["layers" if cfg.is_ssm else "super_mamba"]["ssm"]
    if state.dtype != torch.bfloat16:
        raise AssertionError(f"engine[{label}]: the SSM state is {state.dtype}, not bf16")
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 8)
    live = {"steps": 0, "usage": 0, "fd": 0, "fd_err": 0.0, "snapshot": None}

    def check_live(eng):
        kv, step = eng.kv, live["steps"]
        live["steps"] += 1
        if step % 8:
            return
        occupied = 1.0 - kv.num_free / kv.max_slots
        resident = float(kv.slot_len.sum()) / (kv.max_slots * kv.max_seq)
        want = occupied if cfg.num_attention_layers() == 0 else resident
        if kv.usage() != want:
            raise AssertionError(f"engine[{label}]: usage() {kv.usage()} != {want}")
        live["usage"] += 1
        if not cfg.is_hybrid:
            return
        k, v = kv.cache["super_attn"]["k"][0], kv.cache["super_attn"]["v"][0]
        lengths = torch.as_tensor(kv.slot_len, dtype=torch.int32, device=DEVICE)
        q = torch.randn((kv.max_slots, cfg.num_heads, cfg.head_dim), generator=gen,
                        device=DEVICE).to(cfg.adtype)
        got = ops.decode_attention(q, k, v, lengths)
        live["fd_err"] = max(live["fd_err"], check_close(
            f"flash_decode on {label}'s shared-attention cache", got,
            ref.ref_flash_decode(q, k, v, lengths), *FD_TOL[cfg.dtype]))
        if not (got[lengths == 0] == 0).all():
            raise AssertionError("flash_decode: a free slot's row is not exactly zero")
        live["fd"] += 1
        if live["snapshot"] is None or lengths.sum() > live["snapshot"][3].sum():
            live["snapshot"] = (q, k.clone(), v.clone(), lengths)

    run = _serve(torch, eng, reqs, "decode_step", label, trace=trace, after_decode=check_live)
    want = dict(run["path"], flash_decode_paged=0, flash_decode=live["fd"], topk_router=0)
    if run["launches"] != want:
        raise AssertionError(f"engine[{label}]: launches {run['launches']} != path {want}")
    run.update(snapshot=live["snapshot"], peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               cache_bytes=sum(t.numel() * t.element_size() for t in leaves(eng.kv.cache)))
    log(f"engine[{label}]: state dtype={state.dtype} usage_checks={live['usage']} "
        f"flash_decode_live_checks={live['fd']} flash_decode_live_max_abs_err="
        f"{live['fd_err']:.3e} slot_cache_bytes={run['cache_bytes']} "
        f"peak_device_memory_gib={run['peak_gib']:.2f}")
    return run


def _live_flash_decode(torch, timer: Timer, label: str, snapshot) -> None:
    """Kernel 4 on a run's own slot cache, kept during the run: against its plain
    version, timed beside it and beside one SDPA call (CUDA events, and the
    profiler's device time), its bound from the resident K/V bytes."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode, ref
    from repro_torch.kernels.flash_decode import split_plan

    q, k, v, lengths = snapshot
    b, s, hkv, d = k.shape
    hq = q.shape[1]
    n_tok = int(lengths.sum())
    rtol, atol = FD_TOL["bfloat16"]
    err = check_close(f"flash_decode on {label}", flash_decode(q, k, v, lengths),
                      ref.ref_flash_decode(q, k, v, lengths), rtol, atol)
    mask = (torch.arange(s, device=DEVICE)[None, :] < lengths[:, None])[:, None, None, :]
    qs, kt, vt = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qs, kt, vt, attn_mask=mask, enable_gqa=True)

    ms = timer.ms(lambda: flash_decode(q, k, v, lengths))
    plain = timer.ms(lambda: ref.ref_flash_decode(q, k, v, lengths))
    lib = timer.ms(sdpa)
    nbytes = 2 * q.numel() * 2 + n_tok * hkv * d * 2 * 2 + b * 4
    bound = _bound(nbytes, 4 * n_tok * hq * d, "bfloat16")
    log(f"device time flash_decode {label}: kernel "
        f"[{timer.device_us(lambda: flash_decode(q, k, v, lengths))}] sdpa "
        f"[{timer.device_us(sdpa)}]")
    log(f"kernel flash_decode {label} B={b} S={s} heads={hq}/{hkv}x{d} "
        f"resident={lengths.tolist()} tokens={n_tok} "
        f"n_split={split_plan(b, s, hq, hkv, d, 2).n_split}: max_abs_err={err:.3e} "
        f"(rtol {rtol}, atol {atol}) ms={ms:.4f} plain_ms={plain:.4f} library_ms(sdpa)="
        f"{lib:.4f} bound_ms={bound[0]:.4f} ({bound[1]}) {_tb_s(nbytes, ms)}")


def ssm_phase(torch) -> dict:
    """The SSM and hybrid families at full width, random bf16 weights from
    seed 0, each model freed before the next: the f32 gates of mamba2 at 2
    layers and zamba2 at 3 (``_ssm_gates``); mamba2-370m at full depth (48
    layers) through ``Engine`` (16 requests), one 16383-token row and 32
    decode steps on an engine whose slot cache must hold as many bytes as
    the 1024-position engine's, and a short traced run; zamba2-1.2b at full
    depth (38 layers) through ``Engine`` (16 requests), with kernel 4 held
    on its shared-attention cache and timed there.  Returns each run's
    kernel launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    _free(torch)
    log(f"ssm phase: device memory held on entry "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    for arch, cut in SSM_GATE_CUTS:
        cfg32 = get_config(arch).replace(dtype="float32", **cut)
        params = M.init_params(cfg32, seed=SEED + 1, device=DEVICE)
        _ssm_gates(torch, cfg32, params, f"[{arch}, {cfg32.num_layers} layers]")
        del params
        _free(torch)
    log(f"ssm phase: f32 gates {time.perf_counter() - t0:.1f} s")
    runs = {}
    for arch in (MAMBA2, ZAMBA2):
        t1 = time.perf_counter()
        cfg = get_config(arch)
        params = _family_params(torch, cfg, arch)
        run = _ssm_engine(torch, cfg, params, arch, _requests(cfg, 16, 32))
        runs[arch] = run["launches"]
        if arch == MAMBA2:
            label = f"{arch} long row"
            # the prefill gives the first token, each decode step one more;
            # a row finishes when it reaches max_seq - 1 positions
            max_seq = SSM_LONG_ROW + SSM_LONG_STEPS + 2
            long_row = _ssm_engine(torch, cfg, params, label,
                                   _requests(cfg, 1, SSM_LONG_STEPS + 1, lo=SSM_LONG_ROW,
                                             hi=SSM_LONG_ROW),
                                   max_seq=max_seq, prefill_budget=max_seq)
            if long_row["cache_bytes"] != run["cache_bytes"]:
                raise AssertionError(f"engine[{label}]: the slot cache holds "
                                     f"{long_row['cache_bytes']} bytes at max_seq {max_seq}, "
                                     f"{run['cache_bytes']} at 1024")
            runs[label] = long_row["launches"]
            runs[f"{arch} traced"] = _retraced(lambda **kw: _ssm_engine(
                torch, cfg, params, f"{arch} traced", _requests(cfg, 8, 16), **kw))["launches"]
        else:
            timer = Timer(torch)
            _live_flash_decode(torch, timer, f"{arch}'s shared-attention cache",
                               run["snapshot"])
            del timer
        del params, run
        _free(torch)
        log(f"ssm phase: {arch} {time.perf_counter() - t1:.1f} s")
    log(f"ssm phase: {time.perf_counter() - t0:.1f} s")
    return runs


# ----------------------------------------------------------------------------- train

# T0's optimizer: lr 1e-2 held flat (no warm-up, a cosine horizon of 1e9
# steps), so one step moves a weight by ~1e-2, 50x the 2e-4 gate (the
# train() settings' first step moves it by 3e-5, below the gate); eps 1e-3
# keeps the first step's g / (|g| + eps) smooth in g: at eps 1e-8 a weight
# whose f32 gradient cancels to ~1e-8 moves by up to lr x that gradient's
# rounding error relative to eps: 8.9e-4 on an H100 against the CPU, where
# the moments agreed within 6.3e-9
TRAIN_GATE_OPT = dict(lr=1e-2, eps=1e-3, warmup_steps=0, decay_steps=10**9,
                      moment_dtype="float32")
TRAIN_GATE_SHAPE = (2, 32)                  # T0: batch x seq
TRAIN_GATE_STEP_LOST = 10**4                # step count at which both corrections are 1 in f32
T1_DEPTH, T1_SHAPE, T1_STEPS = 4, (8, 128), 8
T1_MARGIN = 0.1                             # nats the loss on one batch must fall in T1_STEPS
T2_SHAPE, T2_STEPS, T2_GATE_BATCH = (8, 512), 4, 2
# T3's runs stay inside the 10-step warm-up: launch.train sets the cosine
# horizon to its own --steps (as the reference's train() does), so past the
# warm-up a run resumed with another --steps follows another schedule
T3_STEPS, T3_TOTAL, T3_EVERY = 6, 10, 3


def _train_opt(steps: int, **kw):
    """The reference train()'s AdamW settings for a run of ``steps``."""
    from repro_torch.training.optimizer import AdamWConfig
    return AdamWConfig(**dict(dict(moment_dtype="float32", warmup_steps=10, grad_clip=1.0,
                                   decay_steps=max(steps, 2)), **kw))


def _train_batch(torch, cfg, data, step: int, device) -> dict:
    """``data.batch_at(step)`` on ``device``, with identity placements for
    a MoE, as ``launch.train`` feeds its step."""
    from repro_torch.launch import steps as S
    batch = {k: torch.from_numpy(v).to(device) for k, v in data.batch_at(step).items()}
    if cfg.is_moe:
        batch["placements"] = S.placements_input(cfg, device)
    return batch


def _stream(cfg, shape):
    from repro_torch.training.data import DataConfig, TokenStream
    return TokenStream(DataConfig(vocab_size=cfg.vocab_size, global_batch=shape[0],
                                  seq_len=shape[1], seed=0))


def _decay_on_vectors(params, grads, state, cfg):
    """The port's AdamW update with every vector and scalar leaf viewed as a
    (1, n) matrix, so weight decay reaches it: a fault for T0's gate."""
    from repro_torch.training import optimizer as O
    from repro_torch.tree import map_tree
    flat = lambda t: t.reshape(1, -1) if t.ndim < 2 else t
    st = O.AdamWState(state.step, map_tree(flat, state.m), map_tree(flat, state.v))
    p, st, om = O.adamw_update(map_tree(flat, params), map_tree(flat, grads), st, cfg)
    back = lambda new, old: new.reshape(old.shape)
    return (map_tree(back, p, params),
            O.AdamWState(st.step, map_tree(back, st.m, params), map_tree(back, st.v, params)),
            om)


def _train_state_excess(got, want) -> tuple:
    """(max abs err, max excess over rtol = atol = 2e-4, the quantity with
    that excess) of one train step's loss, grad norm, params and moments:
    ``got`` against ``want``, both (params, state, metrics)."""
    from repro_torch.tree import flatten_with_paths
    pairs = [("loss", got[2]["loss"], want[2]["loss"]),
             ("grad_norm", got[2]["grad_norm"], want[2]["grad_norm"])]
    for name, a, b in (("param", got[0], want[0]), ("m", got[1].m, want[1].m),
                       ("v", got[1].v, want[1].v)):
        pairs += [(f"{name} {path}", x, y) for (path, x), (_, y) in
                  zip(flatten_with_paths(a), flatten_with_paths(b))]
    errs = [(*max_excess(a.cpu(), b.cpu(), TOL["float32"], TOL["float32"]), name)
            for name, a, b in pairs]
    worst = max(errs, key=lambda e: e[1])
    return max(e[0] for e in errs), worst[1], worst[2]


def _train_gates(torch, arch: str) -> None:
    """T0: one f32 train step of ``arch``'s smoke config on the card against
    the same step on the CPU (same weights, batch and optimizer), within
    2e-4 on the loss, grad norm, every param and every moment; then three
    faulty steps on the CPU, each outside that gate: weight decay on
    vectors, no bias correction (the port's update from a step count of
    10^4, where both corrections are 1 in f32; the flat lr does not change
    with the step) and the router aux loss dropped (MoE only).  A stacked
    layer's vectors are matrices of the tree (layers x width), which the
    reference decays too; the unstacked ones (the final norm's scale) are
    zeros at init, so the weights' 1-D leaves are drawn from N(0, 1) here
    for the first fault to show."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M
    from repro_torch.training import optimizer as O
    from repro_torch.tree import map_tree

    cfg = get_smoke_config(arch)
    opt = O.AdamWConfig(**TRAIN_GATE_OPT)
    gen = torch.Generator().manual_seed(SEED + 2)
    params = map_tree(lambda t: torch.randn(t.shape, generator=gen) if t.ndim == 1 else t,
                      M.init_params(cfg, seed=SEED + 1, device="cpu"))
    data = _stream(cfg, TRAIN_GATE_SHAPE)

    def step(device, cfg=cfg, state_step: int = 0):
        p = map_tree(lambda t: t.to(device), params)
        st = O.init_adamw(p, opt)
        st = st._replace(step=st.step + state_step)
        fn = S.make_train_step(cfg, None, None, opt, remat=False)[0]
        return fn(p, st, _train_batch(torch, cfg, data, 0, device))

    want = step("cpu")
    err, excess, worst = _train_state_excess(step(DEVICE), want)
    label = f"train[T0 {arch} smoke f32]"
    if excess > 0:
        raise AssertionError(f"{label}: card step disagrees with the CPU's (max abs err "
                             f"{err:.3e}, gate 2e-4, worst {worst})")
    log(f"{label}: card vs CPU loss {float(want[2]['loss']):.6f} grad_norm "
        f"{float(want[2]['grad_norm']):.6f}, max abs err over loss, grad norm, params and "
        f"moments {err:.3e} (gate 2e-4)")
    faults = {"weight decay on vectors": lambda: _with(S, "adamw_update", _decay_on_vectors,
                                                      lambda: step("cpu")),
              "no bias correction": lambda: step("cpu", state_step=TRAIN_GATE_STEP_LOST)}
    if cfg.is_moe:
        faults["router aux loss dropped"] = lambda: step(
            "cpu", cfg=cfg.replace(router_aux_coef=0.0, router_z_coef=0.0))
    for name, run in faults.items():
        ferr, fexcess, fworst = _train_state_excess(run(), want)
        log(f"{label}: fault '{name}' max abs err {ferr:.3e}, excess over the gate "
            f"{fexcess:.3e} ({fworst})")
        if fexcess <= 0:
            raise AssertionError(f"{label}: fault '{name}' falls inside the gate")


def _with(obj, name: str, value, fn):
    """``fn()`` with ``obj.name`` set to ``value``."""
    with mock.patch.object(obj, name, value):
        return fn()


def _timed_steps(torch, fn, carry: list, batches, label: str) -> list:
    """Run ``fn`` over ``batches`` from ``carry`` = [params, state], which
    each step's output replaces (so that no caller keeps an older state
    alive: the update holds old and new state at once), timing each step on
    the host clock (synchronised), split at the optimizer call into
    forward + backward and optimizer.  Returns the per-step records."""
    from repro_torch.launch import steps as S
    upd = S.adamw_update
    mark = {}

    def timed_update(*a, **kw):
        torch.cuda.synchronize()
        mark["opt0"] = time.perf_counter()
        out = upd(*a, **kw)
        torch.cuda.synchronize()
        mark["opt1"] = time.perf_counter()
        return out

    records = []
    with mock.patch.object(S, "adamw_update", timed_update):
        for batch in batches:
            params, state = carry
            carry.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = fn(params, state, batch)
            carry += [params, state]
            del params, state
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            t1 = time.perf_counter()
            rec = dict(loss=loss, grad_norm=gnorm, lr=float(m["lr"]), ms=1e3 * (t1 - t0),
                       fwd_bwd_ms=1e3 * (mark["opt0"] - t0),
                       opt_ms=1e3 * (mark["opt1"] - mark["opt0"]))
            if not (math.isfinite(loss) and math.isfinite(gnorm)):
                raise AssertionError(f"train[{label}]: non-finite loss or grad norm {rec}")
            log(f"train[{label}]: step {len(records)} loss {loss:.4f} grad_norm {gnorm:.4f} "
                f"lr {rec['lr']:.3e} ms {rec['ms']:.3f} (forward+backward "
                f"{rec['fwd_bwd_ms']:.3f}, optimizer {rec['opt_ms']:.3f})")
            records.append(rec)
    return records


def _step_summary(torch, records, tokens: int, label: str, last: int) -> None:
    tail = records[-last:]
    med = {k: statistics.median(r[k] for r in tail) for k in ("ms", "fwd_bwd_ms", "opt_ms")}
    log(f"train[{label}]: median of the last {len(tail)} steps: {med['ms']:.3f} ms a step "
        f"(forward+backward {med['fwd_bwd_ms']:.3f}, optimizer {med['opt_ms']:.3f}), "
        f"{1e3 * tokens / med['ms']:.1f} trained tokens/s, peak_device_memory_gib="
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    return med


def _train_t1(torch) -> None:
    """T1: qwen3-30b-a3b at full width, 4 layers, bf16, batch 8 x 128 with
    dense dispatch: T1_STEPS timed steps on the stream, T1_STEPS more on
    batch 0 repeated, where the loss must fall by T1_MARGIN, which two
    steps at lr 0 (the fault) must not; then one traced step."""
    from repro_torch.configs import at_depth, get_config
    from repro_torch.launch import steps as S
    from repro_torch.training import optimizer as O

    full = get_config(ARCH)
    cfg = at_depth(full, T1_DEPTH)
    label = f"T1 {ARCH}"
    log(f"train[{label}]: reduced: num_layers {full.num_layers} -> {cfg.num_layers}; "
        f"batch {T1_SHAPE[0]} x seq {T1_SHAPE[1]}, {cfg.dtype}, dense dispatch")
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    opt = _train_opt(2 * T1_STEPS)
    carry = [_family_params(torch, cfg, label)]
    carry.append(O.init_adamw(carry[0], opt))
    fn = S.make_train_step(cfg, None, None, opt, remat=False)[0]
    data = _stream(cfg, T1_SHAPE)
    tokens = T1_SHAPE[0] * T1_SHAPE[1]
    recs = _timed_steps(torch, fn, carry, (_train_batch(torch, cfg, data, i, DEVICE)
                                           for i in range(T1_STEPS)), label)
    T1_RESULT["T1"] = _step_summary(torch, recs, tokens, label, T1_STEPS - 2)
    T1_RESULT["losses"] = [r["loss"] for r in recs]
    batch0 = _train_batch(torch, cfg, data, 0, DEVICE)
    rep = _timed_steps(torch, fn, carry, [batch0] * T1_STEPS, f"{label} batch 0")
    drop = rep[0]["loss"] - rep[-1]["loss"]
    fn0 = S.make_train_step(cfg, None, None, _train_opt(2 * T1_STEPS, lr=0.0), remat=False)[0]
    lr0 = _timed_steps(torch, fn0, carry, [batch0] * 2, f"{label} lr 0")
    drop0 = lr0[0]["loss"] - lr0[1]["loss"]
    log(f"train[{label}]: loss on batch 0 fell {drop:.4f} in {T1_STEPS} steps "
        f"({rep[0]['loss']:.4f} -> {rep[-1]['loss']:.4f}); fault lr 0: {drop0:.4f} in 2 "
        f"steps; margin {T1_MARGIN}")
    if not drop > T1_MARGIN >= drop0:
        raise AssertionError(f"train[{label}]: the loss fell {drop:.4f}, lr 0 {drop0:.4f}: "
                             f"not separated by the margin {T1_MARGIN}")

    def traced(trace: bool):
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*carry, batch0)
            float(out[2]["loss"])
            wall = time.perf_counter() - t0
        del out
        rows = _report_trace(prof, wall, f"{label} step", None)
        if not rows:
            raise EmptyTrace(f"trace[{label} step]: the profiler recorded no device event")

    _retraced(traced)
    carry.clear()


REMAT_POLICIES = (None, "none", "dots", "full")     # None: no remat
T1_RESULT = {}                                      # T1's medians, printed beside T1c's


def _remat_loss(torch, cfg, params, batch):
    """The train step's loss (cross-entropy plus the router terms)."""
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M
    logits, aux = M.forward_train(params, cfg, batch["tokens"],
                                  placements=batch.get("placements"))
    loss = S.cross_entropy(logits, batch["labels"])
    if cfg.is_moe:
        loss = loss + cfg.router_aux_coef * aux["load_balance_loss"] \
            + cfg.router_z_coef * aux["router_z_loss"]
    return loss


def _remat_gates(torch, ctx) -> None:
    """The smoke qwen3 in f32 on the card under the context: gradients
    under remat_policy "none", "dots" and "full" within 2e-4 of those
    without remat (the recomputation runs on autograd's own thread for the
    card, under the forward's context); the planted fault (the gates'
    gradient cut under "dots") outside it."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.context import shard_ctx
    from repro_torch.launch import steps as S
    from repro_torch.models import moe_sharded as MS
    from repro_torch.tree import leaves

    cfg = get_smoke_config(ARCH)
    params = _family_params(torch, cfg, f"{ARCH} smoke remat")
    batch = _train_batch(torch, cfg, _stream(cfg, TRAIN_GATE_SHAPE), 0, DEVICE)

    def grads(policy, fault=None):
        c = cfg if policy is None else cfg.replace(remat=True, remat_policy=policy)
        with shard_ctx(ctx), (fault() if fault else contextlib.nullcontext()):
            return S.value_and_grad(lambda p: _remat_loss(torch, c, p, batch), params)[1]

    def cut_gates():
        real = MS.top_k_gating
        return mock.patch.object(MS, "top_k_gating",
                                 lambda probs, k: tuple(t.detach() for t in real(probs, k)))

    want = leaves(grads(None))
    errs = {}
    for name, policy, fault in (("none", "none", None), ("dots", "dots", None),
                                ("full", "full", None),
                                ("fault: dots, gates' gradient cut", "dots", cut_gates)):
        got = leaves(grads(policy, fault))
        errs[name] = max((a - b).abs().max().item() for a, b in zip(got, want))
    log(f"train[remat {ARCH} smoke f32, ctx]: max abs gradient difference from no remat: "
        f"{errs} (gate 2e-4)")
    if not (max(errs["none"], errs["dots"], errs["full"]) <= 2e-4
            and errs["fault: dots, gates' gradient cut"] > 2e-4):
        raise AssertionError(f"train[remat]: gradients {errs} on the wrong side of 2e-4")


def _train_t1c(torch) -> None:
    """T1c: T1's model and shape through ``launch.train``'s context path
    (``make_mesh`` (1, 1) over the NCCL group, ``make_ctx``,
    ``make_train_step`` with the context, so every MoE layer runs
    ``moe_apply_sharded``): T1_STEPS timed steps beside T1's; then the peak
    memory of one forward + backward under each remat policy, and the f32
    remat gates."""
    from repro_torch.configs import at_depth, get_config
    from repro_torch.distributed.context import shard_ctx
    from repro_torch.distributed.sharding import input_shardings, place
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.config import ShapeCell
    from repro_torch.training import optimizer as O

    full = get_config(ARCH)
    cfg = at_depth(full, T1_DEPTH)
    label = f"T1c {ARCH}"
    ctx = S.make_ctx(make_mesh((1, 1), ("data", "model"), device=DEVICE))
    log(f"train[{label}]: reduced: num_layers {full.num_layers} -> {cfg.num_layers}; batch "
        f"{T1_SHAPE[0]} x seq {T1_SHAPE[1]}, {cfg.dtype}; the (1, 1) mesh's context "
        f"(expert-parallel MoE)")
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    opt = _train_opt(2 * T1_STEPS)
    cell = ShapeCell("T1c", T1_SHAPE[1], T1_SHAPE[0], "train")
    fn, (pspec, _), _ = S.make_train_step(cfg, ctx, cell, opt, remat=False)
    carry = [place(_family_params(torch, cfg, label), pspec, ctx.mesh)]
    carry.append(O.init_adamw(carry[0], opt))
    data = _stream(cfg, T1_SHAPE)

    def stored_batch(i):
        b = _train_batch(torch, cfg, data, i, DEVICE)
        return place(b, input_shardings(cfg, ctx, cell, b), ctx.mesh)

    with _CollectiveCount() as coll:
        recs = _timed_steps(torch, fn, carry, (stored_batch(i) for i in range(T1_STEPS)),
                            label)
    med = _step_summary(torch, recs, T1_SHAPE[0] * T1_SHAPE[1], label, T1_STEPS - 2)
    log(f"train[{label}]: ctx path (the batch stored in blocks over \"data\", every layer "
        f"on its \"model\" blocks): collectives a step by kind "
        f"{_by_kind(coll.counts, T1_STEPS)}")
    t1 = T1_RESULT.get("T1")
    if t1:
        log(f"train[{label}]: ctx path {med['ms']:.3f} ms a step (forward+backward "
            f"{med['fwd_bwd_ms']:.3f}, optimizer {med['opt_ms']:.3f}) beside T1's ctx-free "
            f"{t1['ms']:.3f} (forward+backward {t1['fwd_bwd_ms']:.3f}, optimizer "
            f"{t1['opt_ms']:.3f}) in this run")
    if not all(abs(a["loss"] - b) < 5e-2 for a, b in zip(recs, T1_RESULT.get("losses", []))):
        raise AssertionError(f"train[{label}]: losses {[r['loss'] for r in recs]} are not "
                             f"T1's {T1_RESULT.get('losses')}")
    params = carry[0]
    carry.clear()
    batch = _train_batch(torch, cfg, data, 0, DEVICE)
    for policy in REMAT_POLICIES:
        c = cfg if policy is None else cfg.replace(remat=True, remat_policy=policy)
        _free(torch)
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with shard_ctx(ctx):
            loss, grads = S.value_and_grad(lambda p: _remat_loss(torch, c, p, batch), params)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        log(f"train[{label}]: remat {policy or 'off'}: forward+backward {ms:.3f} ms, loss "
            f"{float(loss):.4f}, peak_device_memory_gib="
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} (params held "
            f"{held / 2**30:.2f})")
        del grads
    del params
    _free(torch)
    _remat_gates(torch, ctx)


def _train_t2(torch) -> None:
    """T2: mamba2-370m at full depth (48 layers), bf16, batch 8 x 512 (the
    SSD's 256-position chunks cross a boundary in the backward), remat on:
    T2_STEPS timed steps with a checkpoint after step 2, restored into fresh
    tensors and run to the end, which must equal the uninterrupted run bit
    for bit (faults: a checkpoint without its manifest is ignored, a leaf
    of the wrong shape is refused); remat on and off at batch 2 must give
    the same loss and grad norm."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M
    from repro_torch.training import checkpoint as C
    from repro_torch.training import optimizer as O
    from repro_torch.tree import leaves

    cfg = get_config(MAMBA2)
    label = f"T2 {MAMBA2}"
    log(f"train[{label}]: no cut ({cfg.num_layers} layers); batch {T2_SHAPE[0]} x seq "
        f"{T2_SHAPE[1]}, {cfg.dtype}, remat on")
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    params = _family_params(torch, cfg, label)
    opt = _train_opt(T2_STEPS)
    fn = S.make_train_step(cfg, None, None, opt)[0]               # remat=True
    data = _stream(cfg, T2_SHAPE)
    batches = [_train_batch(torch, cfg, data, i, DEVICE) for i in range(T2_STEPS)]
    with tempfile.TemporaryDirectory() as d:
        run = [params, O.init_adamw(params, opt)]
        recs = _timed_steps(torch, fn, run, batches[:2], label)
        C.save_checkpoint(d, 2, tuple(run))
        recs += _timed_steps(torch, fn, run, batches[2:], label)
        _step_summary(torch, recs, T2_SHAPE[0] * T2_SHAPE[1], label, T2_STEPS - 1)
        fresh = (M.init_params(cfg, seed=SEED + 7, device=DEVICE), O.init_adamw(params, opt))
        (Path(d) / "step_00000009").mkdir()
        (Path(d) / "step_00000009" / "leaf_00000.npy").write_bytes(b"junk")
        if C.latest_step(d) != 2:
            raise AssertionError(f"train[{label}]: latest_step {C.latest_step(d)} trusts a "
                                 "checkpoint without its manifest")
        step, resumed = C.restore_checkpoint(d, fresh)
        del fresh
        _refuses_wrong_shape(C, d, resumed, label)
        resumed = list(resumed)
        rec2 = _timed_steps(torch, fn, resumed, batches[2:],
                            f"{label} resumed from step {step}")
    same = ([r["loss"] for r in rec2] == [r["loss"] for r in recs[2:]]
            and all(torch.equal(a, b) for a, b in zip(leaves(resumed), leaves(run))))
    log(f"train[{label}]: resumed from step {step}: steps 3-{T2_STEPS} losses and every "
        f"param and moment bit-identical to the uninterrupted run: {same}")
    if not same:
        raise AssertionError(f"train[{label}]: the resumed run differs from the "
                             "uninterrupted one")
    del run, resumed
    small = {k: v[:T2_GATE_BATCH] for k, v in batches[0].items()}
    out = {}
    for remat in (True, False):
        _free(torch)
        torch.cuda.reset_peak_memory_stats()
        f = S.make_train_step(cfg, None, None, opt, remat=remat)[0]
        _, _, m = f(params, O.init_adamw(params, opt), small)
        out[remat] = (float(m["loss"]), float(m["grad_norm"]))
        log(f"train[{label}]: batch {T2_GATE_BATCH}, remat {remat}: loss {out[remat][0]!r} "
            f"grad_norm {out[remat][1]!r}, peak_device_memory_gib="
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(out[True], out[False]))
    log(f"train[{label}]: remat on vs off: bit-identical {out[True] == out[False]}, max "
        f"relative difference {rel:.3e}")
    if rel > 1e-6:
        raise AssertionError(f"train[{label}]: remat changes the numbers ({rel:.3e})")
    del params


def _refuses_wrong_shape(C, directory, state, label: str) -> None:
    """The fault of T2's restore: a ``like`` tree whose first leaf is one
    column short must make ``restore_checkpoint`` raise."""
    from repro_torch.tree import leaves, unflatten
    like = leaves(state)
    try:
        C.restore_checkpoint(directory, unflatten(state, [like[0][..., :-1]] + like[1:]))
    except ValueError as exc:
        log(f"train[{label}]: fault: a leaf of the wrong shape is refused ({exc})")
        return
    raise AssertionError(f"train[{label}]: restore took a leaf of the wrong shape")


def _train_t3(torch) -> None:
    """T3: the entry point as a user runs it, in a subprocess on the card:
    ``python -m repro_torch.launch.train`` for T3_STEPS steps with a
    checkpoint every T3_EVERY, then again to T3_TOTAL, which must resume
    from step T3_STEPS; its first and last losses and its final checkpoint
    must equal an uninterrupted run's (in this process)."""
    import os
    import tempfile
    import numpy as np
    from repro_torch.launch.train import train

    label = f"T3 {ARCH} smoke"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as d:
        cut, whole = Path(d) / "cut", Path(d) / "whole"
        outs = []
        for steps in (T3_STEPS, T3_TOTAL):
            cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
                   "--steps", str(steps), "--ckpt-dir", str(cut), "--ckpt-every",
                   str(T3_EVERY), "--device", DEVICE]
            t0 = time.perf_counter()
            run = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=600)
            if run.returncode != 0:
                raise AssertionError(f"train[{label}]: {' '.join(cmd[1:])} exited "
                                     f"{run.returncode}: {run.stderr[-2000:]}")
            log(f"train[{label}]: {' '.join(cmd[2:])}: {time.perf_counter() - t0:.1f} s")
            for line in run.stdout.splitlines():
                log(f"  {line}")
            outs.append(run.stdout)
        if f"[train] resumed from step {T3_STEPS}" not in outs[1]:
            raise AssertionError(f"train[{label}]: the rerun did not resume from step "
                                 f"{T3_STEPS}")
        losses = train(ARCH, steps=T3_TOTAL, ckpt_dir=str(whole), ckpt_every=100,
                       log_every=10**6, device=DEVICE)
        want = (f"first loss {losses[T3_STEPS]:.4f} last loss {losses[-1]:.4f}")
        a, b = (c / f"step_{T3_TOTAL:08d}" for c in (cut, whole))
        files = sorted(p.name for p in a.glob("leaf_*.npy"))
        same = files == sorted(p.name for p in b.glob("leaf_*.npy")) and all(
            np.array_equal(np.load(a / f), np.load(b / f)) for f in files)
        log(f"train[{label}]: uninterrupted {T3_TOTAL}-step run in this process: {want}; "
            f"the resumed run's final checkpoint ({len(files)} leaves) bit-identical: {same}")
        if want not in outs[1] or not same:
            raise AssertionError(f"train[{label}]: the resumed run differs from the "
                                 "uninterrupted one")


def train_phase(torch) -> dict:
    """Training through ``repro_torch.launch``: the f32 gates (T0), qwen3
    at full width (T1), mamba2-370m at full depth (T2) and the entry point
    with a resume (T3).  Returns each part's kernel launches, which must be
    0: training runs the dense forward, which reaches no kernel."""
    from repro_torch import kernels as K

    _free(torch)
    log(f"train phase: device memory held on entry "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    runs = {}
    parts = (("T0", lambda: [_train_gates(torch, a) for a in (ARCH, MAMBA2)]),
             ("T1", lambda: _train_t1(torch)), ("T1c", lambda: _train_t1c(torch)),
             ("T2", lambda: _train_t2(torch)), ("T3", lambda: _train_t3(torch)))
    for name, part in parts:
        t1 = time.perf_counter()
        K.reset_launch_counts()
        part()
        runs[name] = {fn.__name__: fn.launches for fn in K.KERNELS}
        _free(torch)
        log(f"train phase: {name} {time.perf_counter() - t1:.1f} s, launches {runs[name]}")
    if any(n for counts in runs.values() for n in counts.values()):
        raise AssertionError(f"train phase: training launched a kernel: {runs}")
    log(f"train phase: {time.perf_counter() - t0:.1f} s")
    return runs


# ----------------------------------------------------------------------------- ctx phase

CTX_ROWS, CTX_PROMPT, CTX_STEPS = 8, 128, 16     # rows, prompt tokens, decode steps
CTX_DEPTH = 4                                    # the engine runs' cut (48 / 60 -> 4 layers)
_COLLECTIVES = ("all_reduce", "all_gather_single", "all_gather_into_tensor",
                "reduce_scatter_single", "reduce_scatter_tensor", "all_to_all_single")


def _ctx_mesh(torch):
    """The single-rank NCCL group (started by ``launch.mesh.make_mesh`` over
    a FileStore in a temporary directory) and its (1, 1) mesh.  One psum on
    the card checks that the group runs."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, 1), ("data", "model"), device=DEVICE)
    x = torch.arange(4.0, device=DEVICE)
    y = mesh.psum(x, "model")
    backend = dist.get_backend(mesh.group("model"))
    if "nccl" not in str(backend) or not torch.equal(x, y):
        raise AssertionError(f"ctx: the group's backend {backend} / psum {y} is not NCCL's")
    log(f"ctx: process group {backend}, world size {dist.get_world_size()}, rank "
        f"{dist.get_rank()}; mesh {mesh.shape}; a psum on the card returned its input")
    return mesh


_KIND = {"all_reduce": "all-reduce", "all_gather_single": "all-gather",
         "all_gather_into_tensor": "all-gather", "reduce_scatter_single": "reduce-scatter",
         "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all"}


def _by_kind(counts: dict, per: int = 1) -> dict:
    """Collective calls by kind (all-gather, all-reduce, reduce-scatter,
    all-to-all), divided by ``per``."""
    out = {}
    for name, n in counts.items():
        out[_KIND[name]] = out.get(_KIND[name], 0) + n
    return {k: v / per if per > 1 else v for k, v in sorted(out.items())}


class _CollectiveCount:
    """Counts the ``torch.distributed`` collectives called while active."""

    def __init__(self):
        import torch.distributed as dist
        self.counts = {}
        self._patches = [mock.patch.object(dist, name, self._wrap(name, getattr(dist, name)))
                         for name in _COLLECTIVES if hasattr(dist, name)]

    def _wrap(self, name, fn):
        def call(*a, **kw):
            self.counts[name] = self.counts.get(name, 0) + 1
            return fn(*a, **kw)
        return call

    def __enter__(self):
        for p in self._patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self._patches:
            p.stop()


def _ctx_scope(ctx):
    from repro_torch.distributed.context import shard_ctx
    return shard_ctx(ctx) if ctx is not None else contextlib.nullcontext()


def _ctx_prompts(torch, cfg, rows: int, length: int, seed: int):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (rows, length), generator=gen).to(DEVICE)


def _ctx_serve(torch, cfg, params, ctx, prompts, label: str,
               steps: int = CTX_STEPS) -> dict:
    """The step makers' path with ``ctx`` (None: the plain path): the
    prefill step's first tokens, a prefill into a cache with room for
    ``steps`` more positions (its snapshot kept), then ``steps`` timed
    decode steps, each row fed its own last token."""
    from repro_torch.distributed.sharding import gather, input_shardings, place
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M
    from repro_torch.models.config import ShapeCell
    from repro_torch.tree import map_tree
    b, p = prompts.shape
    pl = S.placements_input(cfg, DEVICE)
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    pre = S.make_prefill_step(cfg, ctx, ShapeCell("p", p, b, "prefill"))[0]
    dcell = ShapeCell("d", p + steps, b, "decode")
    dec = S.make_decode_step(cfg, ctx, dcell)[0]
    params, cache = _on_store(torch, cfg, ctx, params,
                              M.init_cache(cfg, b, p + steps, device=DEVICE), b, p + steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first, pcache = pre(params, {"tokens": prompts, "placements": pl})
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    del pcache
    first = gather(first)
    with torch.no_grad(), _ctx_scope(ctx):
        M.prefill(params, cfg, prompts, cache, placements=pl)
    snapshot = map_tree(lambda x: gather(x).clone(), cache)
    nxt, toks, ms = first, [], []
    with _CollectiveCount() as coll:
        for i in range(steps):
            batch = {"tokens": nxt[:, None], "placements": pl,
                     "cache_pos": torch.full((b,), p + i, dtype=torch.int32, device=DEVICE)}
            if ctx is not None:
                batch = place(batch, input_shardings(cfg, ctx, dcell, batch), ctx.mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nxt, cache = dec(params, cache, batch)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            nxt = gather(nxt)
            toks.append(nxt)
    del cache
    out = dict(first=first, tokens=torch.stack(toks), ms=ms, snapshot=snapshot,
               seq=p + steps,
               collectives=_by_kind({k: v // steps for k, v in coll.counts.items()}),
               peak=torch.cuda.max_memory_allocated() / 2**30, prefill_ms=prefill_ms)
    log(f"ctx[{label}]: prefill step {prefill_ms:.3f} ms ({b} x {p}), decode ms a step "
        f"median {statistics.median(ms[2:]):.3f} (min {min(ms[2:]):.3f}, max "
        f"{max(ms[2:]):.3f}, first {ms[0]:.3f}), collectives a decode step "
        f"{out['collectives']}, peak_device_memory_gib={out['peak']:.2f}")
    return out


def _on_store(torch, cfg, ctx, params, cache, b: int, s: int):
    """(params, cache of ``b`` rows x ``s`` positions) on the store of
    ``ctx``'s mesh (each rank's block of every leaf its spec splits; on one
    rank the block is the whole tensor, held without a copy), or as they
    are without a context."""
    from repro_torch.distributed.sharding import cache_specs, param_specs, place
    if ctx is None:
        return params, cache
    return (place(params, param_specs(cfg, ctx), ctx.mesh),
            place(cache, cache_specs(cfg, ctx, b, s), ctx.mesh))


def _ctx_step_logits(torch, cfg, params, ctx, run: dict):
    """One decode step, teacher-forced: ``run``'s first tokens on a copy of
    its post-prefill cache, under ``ctx`` (MLA absorbed as it says; on the
    store); returns (f32 logits, aux with the MoE stats)."""
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M
    from repro_torch.tree import map_tree
    b, p = run["first"].shape[0], CTX_PROMPT
    absorb = ctx.mla_absorb if ctx is not None else False
    params, cache = _on_store(torch, cfg, ctx, params, map_tree(torch.clone, run["snapshot"]),
                              b, run["seq"])
    with torch.no_grad(), _ctx_scope(ctx):
        logits, _, aux = M.decode_step(
            params, cfg, run["first"][:, None], cache,
            torch.full((b,), p, dtype=torch.int32, device=DEVICE),
            placements=S.placements_input(cfg, DEVICE), stats=cfg.is_moe, mla_absorb=absorb)
    return logits.float(), aux


def _moe_ids_same_input(torch, cfg, params, ctx, run: dict) -> tuple:
    """Each MoE layer's input in a ctx'd decode step, fed to both
    ``moe_apply_sharded`` and ``moe_apply`` (dense, the plain path's):
    expert ids and counts equal, outputs within the bf16 tolerance.
    Returns (layers checked, largest output difference)."""
    from repro_torch.distributed.context import gather_tree
    from repro_torch.models import blocks as Bk
    from repro_torch.models import moe as MoE
    from repro_torch.models.moe_sharded import moe_apply_sharded
    seen = []
    real = Bk._moe

    def spy(p, c, h, placement, mode, stats):
        seen.append((p, h.clone(), placement))
        return real(p, c, h, placement, mode, stats)

    with mock.patch.object(Bk, "_moe", spy):
        _ctx_step_logits(torch, cfg, params, ctx, run)
    worst = -math.inf
    with torch.no_grad():
        for p, h, plc in seen:
            ys, a_s = moe_apply_sharded(gather_tree(p, keep=("w_gate", "w_up", "w_down")),
                                        cfg, h, plc, ctx, True)
            yp, a_p = MoE.moe_apply(gather_tree(p), cfg, h, plc, "dense", True)
            if not (torch.equal(a_s["expert_ids"], a_p["expert_ids"])
                    and torch.equal(a_s["expert_counts"], a_p["expert_counts"])):
                raise AssertionError("ctx: the sharded MoE routed otherwise than moe_apply "
                                     "on the same input")
            worst = max(worst, max_excess(ys, yp, TOL[cfg.dtype], TOL[cfg.dtype])[1])
    if worst > 0:
        raise AssertionError(f"ctx: the sharded MoE's output is {worst:.3e} from moe_apply's")
    return len(seen), worst


def _ctx_compare(torch, cfg, params, label: str, base, other, faults: dict,
                 bf16_logits: bool = True) -> dict:
    """The gates of one ctx comparison: ``base`` and ``other`` are (name,
    ctx) pairs.  Each path runs twice, and its tokens must repeat; the
    sharded MoE must route each layer's input as ``moe_apply`` does.  In
    f32 the two paths' first tokens and token streams must be identical,
    one teacher-forced decode step's logits within 2e-4, and each planted
    fault (name -> patch) outside it.  In bf16 the paths' last-bit
    differences tip router near-ties (a row then takes other experts, and
    its logits and later tokens move): the logits of every row that both
    paths routed alike in every layer must be within the bf16 tolerance
    (unless ``bf16_logits`` is off: two formulas that round differently),
    and the token agreement is printed."""
    prompts = _ctx_prompts(torch, cfg, CTX_ROWS, CTX_PROMPT, SEED)
    runs = {}
    for name, ctx in (base, other):
        first = _ctx_serve(torch, cfg, params, ctx, prompts, f"{label} {name}")
        again = _ctx_serve(torch, cfg, params, ctx, prompts, f"{label} {name} rerun")
        if not (torch.equal(first["first"], again["first"])
                and torch.equal(first["tokens"], again["tokens"])):
            raise AssertionError(f"ctx[{label}]: {name}'s tokens differ between two runs")
        runs[name] = first
        del again
    (bname, bctx), (oname, octx) = base, other
    a, b = runs[bname], runs[oname]
    same_first = torch.equal(a["first"], b["first"])
    same = int((a["tokens"] == b["tokens"]).sum()), a["tokens"].numel()
    log(f"ctx[{label}]: {oname} vs {bname}: first tokens identical {same_first}; decode "
        f"tokens identical {same[0]} / {same[1]}; each path's two runs identical")
    la, aa = _ctx_step_logits(torch, cfg, params, bctx, a)
    lb, ab = _ctx_step_logits(torch, cfg, params, octx, a)
    tol = TOL[cfg.dtype]
    keep = torch.ones(la.shape[0], dtype=torch.bool, device=la.device)
    if "expert_ids" in aa:
        keep = ~(aa["expert_ids"] != ab["expert_ids"]).flatten(2).any(-1).any(0)
    err, excess = max_excess(lb[keep], la[keep], tol, tol)
    fault_err = {}
    for fname, patch in faults.items():
        with patch():
            lf, _ = _ctx_step_logits(torch, cfg, params, octx, a)
        fault_err[fname] = max_excess(lf, la, tol, tol)
    moved = (lb[~keep] - la[~keep]).abs().max().item() if not keep.all() else 0.0
    log(f"ctx[{label}]: teacher-forced decode step logits {oname} vs {bname}, rows routed "
        f"alike {int(keep.sum())} / {keep.numel()}: max_abs_err {err:.3e}, excess over "
        f"rtol = atol = {tol}: {excess:.3e}; rows a router near-tie sent elsewhere: max_abs_err "
        f"{moved:.3e}; planted faults {{"
        + ", ".join(f"{k}: max_abs_err {v[0]:.3e} excess {v[1]:.3e}"
                    for k, v in fault_err.items()) + "}")
    if cfg.is_moe and octx is not None:
        layers, worst = _moe_ids_same_input(torch, cfg, params, octx, a)
        log(f"ctx[{label}]: sharded MoE on each of {layers} MoE layers' inputs: expert ids and "
            f"counts equal to moe_apply's, outputs' excess over the tolerance {worst:.3e}")
    exact = cfg.dtype == "float32"
    if exact and not (same_first and same[0] == same[1] and keep.all()):
        raise AssertionError(f"ctx[{label}]: {oname}'s tokens or routing differ from "
                             f"{bname}'s in f32")
    held = exact or bf16_logits
    if held and not (keep.any() and excess <= 0) or any(not v[1] > 0
                                                        for v in fault_err.values()):
        raise AssertionError(f"ctx[{label}]: logits {err:.3e} or a fault {fault_err} on the "
                             f"wrong side of rtol = atol = {tol}")
    return runs


def _decode_all_reduces(cfg, blocks: bool) -> int:
    """The all-reduces one ctx decode step of an attention stack issues
    (none is skipped on one rank): the embedding's sum over "model"; per
    layer ``wo``'s partial sums and the flash-decode combine's pmax and two
    psums; per MoE layer its expert combine and, with the batch in blocks
    (``blocks``), its router statistics; per dense FFN ``w_down``'s
    partial sums."""
    moe = cfg.num_moe_layers() if cfg.is_moe else 0
    return 1 + 4 * cfg.num_layers + (2 if blocks else 1) * moe + (cfg.num_layers - moe)


def _wo_without_reduce():
    """Fault: a decode's ``wo`` on the rank's heads, its partial sums not
    reduced over "model" (on one rank the same values, one all-reduce a
    layer fewer)."""
    from repro_torch.models import attention as A
    return mock.patch.object(A, "reduce_from_model", lambda x, ctx: x)


def _decode_collective_gate(torch, cfg, params, ctx, run: dict, label: str) -> dict:
    """The all-reduces of the served ctx decode steps (batch in blocks)
    and of one teacher-forced ctx decode step (the batch whole) must be
    ``_decode_all_reduces``'s, which must reject a step whose ``wo`` output
    skips its reduce."""
    served, want, got = run["collectives"].get("all-reduce"), _decode_all_reduces(cfg, False), {}
    if served != _decode_all_reduces(cfg, True):
        raise AssertionError(f"ctx[{label}]: {served} all-reduces a served decode step, "
                             f"expected {_decode_all_reduces(cfg, True)}")
    for name, fault in (("ctx", None), ("fault: wo without its reduce", _wo_without_reduce)):
        with (fault() if fault is not None else contextlib.nullcontext()), \
                _CollectiveCount() as coll:
            _ctx_step_logits(torch, cfg, params, ctx, run)
        got[name] = _by_kind(coll.counts)
    log(f"ctx[{label}]: all-reduces a served decode step {served} (expected "
        f"{_decode_all_reduces(cfg, True)}: embedding 1, per layer wo 1 + flash-decode "
        f"combine 3, per MoE layer 2, per dense FFN 1); a teacher-forced step, batch whole: "
        f"collectives by kind {got['ctx']}, all-reduces expected {want} (no router "
        f"statistics sum); planted fault {got['fault: wo without its reduce']}")
    if got["ctx"].get("all-reduce") != want or \
            got["fault: wo without its reduce"].get("all-reduce") == want:
        raise AssertionError(f"ctx[{label}]: decode all-reduces {got}, expected {want} (and "
                             f"not with the fault)")
    return got["ctx"]


def _no_row_write():
    """Fault: the sequence-sharded decodes attend without writing the new
    row into their chunk (it reaches the cache only after the region)."""
    from repro_torch.models import attention as A
    return mock.patch.object(A, "_write_row_guarded", lambda *a, **kw: None)


def _ungated_combine():
    """Fault: the sharded MoE sums each token's k expert rows ungated."""
    from repro_torch.models import moe_sharded as MS
    real = MS._combine
    return mock.patch.object(MS, "_combine",
                             lambda ye, idx, g, dtype: real(ye, idx, g.new_ones(g.shape), dtype))


def _ctx_attribution(torch, cfg, params, label: str, ctx, plain: dict) -> None:
    """Which formula difference moves the ctx path's bf16 tokens off the
    plain path's: the ctx path run again with the plain path's attention
    decode (``attention`` sees no context), with its MoE (``blocks._moe``
    takes ``moe_apply``'s dense dispatch), and with both.  With the plain
    attention decode the rest of the ctx path (the single-rank group and
    its collectives, the sharded MoE, the step makers' context) must give
    the plain path's tokens exactly, and must not with a MoE combine
    without gates."""
    from repro_torch.models import attention as A
    from repro_torch.models import blocks as Bk
    swaps = {"plain attention": ((A,), None), "moe_apply": ((Bk,), None),
             "both": ((A, Bk), None),
             "plain attention, fault: MoE combine without gates": ((A,), _ungated_combine)}
    prompts = _ctx_prompts(torch, cfg, CTX_ROWS, CTX_PROMPT, SEED)
    agree = {}
    for name, (mods, fault) in swaps.items():
        with contextlib.ExitStack() as stack:
            for mod in mods:
                stack.enter_context(mock.patch.object(mod, "current_ctx", lambda: None))
            if fault is not None:
                stack.enter_context(fault())
            run = _ctx_serve(torch, cfg, params, ctx, prompts, f"{label} ctx, {name}")
        agree[name] = (bool(torch.equal(run["first"], plain["first"])),
                       int((run["tokens"] == plain["tokens"]).sum()))
    n = plain["tokens"].numel()
    log(f"ctx[{label}]: ctx path with the plain path's formulas swapped in, decode tokens "
        f"identical to the plain path's (first tokens identical): "
        + ", ".join(f"{k} {v[1]} / {n} ({v[0]})" for k, v in agree.items()))
    fault = agree["plain attention, fault: MoE combine without gates"]
    if not (agree["plain attention"] == agree["both"] == (True, n) and fault != (True, n)):
        raise AssertionError(f"ctx[{label}]: with the plain attention decode the ctx path's "
                             f"tokens are not the plain path's, or the fault's are: {agree}")


def ctx_phase(torch) -> dict:
    """The shard context on one card: a single-rank NCCL group and its
    (1, 1) mesh, then qwen3-30b-a3b (ctx against the plain path),
    deepseek-v2 (MLA absorbed against naive, both under the ctx).  Returns
    each run's kernel
    launches, which must be 0: the sharded MoE and the sequence-sharded
    decodes are einsum bodies in the reference as here."""
    from repro_torch import kernels as K
    from repro_torch.configs import at_depth, get_config
    from repro_torch.launch import steps as S

    _free(torch)
    t0 = time.perf_counter()
    mesh = _ctx_mesh(torch)
    runs = {}
    qwen3 = (("plain", None), ("ctx", S.make_ctx(mesh)))
    deepseek = (("ctx naive", S.make_ctx(mesh)),
                ("ctx absorbed", S.make_ctx(mesh, mla_absorb=True)))
    # absorbed and naive MLA round differently in bf16 (the latent queries
    # are rounded once more); the reference holds them together in f32 only
    for arch, paths, depth, dtype, faults, bf16_logits in (
            (ARCH, qwen3, CTX_DEPTH, "float32",
             {"decode without its row write": _no_row_write,
              "MoE combine without gates": _ungated_combine}, True),
            (ARCH, qwen3, CTX_DEPTH, "bfloat16", {}, True),
            (DEEPSEEK, deepseek, 2, "float32",
             {"absorbed decode without its row write": _no_row_write}, True),
            (DEEPSEEK, deepseek, CTX_DEPTH, "bfloat16", {}, False)):
        full = get_config(arch)
        cfg = at_depth(full, depth).replace(dtype=dtype)
        label = f"{arch} {depth} layers {dtype}"
        log(f"ctx[{label}]: reduced: num_layers {full.num_layers} -> {cfg.num_layers}; "
            f"{CTX_ROWS} rows x {CTX_PROMPT} prompt tokens, {CTX_STEPS} decode steps, "
            f"seed {SEED} weights")
        t1 = time.perf_counter()
        params = _family_params(torch, cfg, label)
        K.reset_launch_counts()
        served = _ctx_compare(torch, cfg, params, label, *paths, faults, bf16_logits)
        if arch == ARCH and dtype == "float32":
            _decode_collective_gate(torch, cfg, params, paths[1][1], served["ctx"], label)
        if arch == ARCH and dtype == "bfloat16":
            _ctx_attribution(torch, cfg, params, label, paths[1][1], served["plain"])
        runs[label] = {fn.__name__: fn.launches for fn in K.KERNELS}
        del params
        _free(torch)
        log(f"ctx[{label}]: {time.perf_counter() - t1:.1f} s, launches {runs[label]}")
    if any(n for counts in runs.values() for n in counts.values()):
        raise AssertionError(f"ctx phase: a run launched a kernel: {runs}")
    log(f"ctx phase: {time.perf_counter() - t0:.1f} s")
    return runs


# ----------------------------------------------------------------------------- store phase

def _storage_bytes(tensors) -> int:
    """The bytes of the storages under ``tensors``, each storage once."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def store_phase(torch) -> None:
    """The store on the card: on the (1, 1) mesh of a one-rank NCCL group,
    qwen3 at T1_DEPTH layers (bf16, seed weights), the store of T1c's
    train cell (params, AdamW state with the dry run's bf16 moments, the
    batch) and of a decode cell of CTX_ROWS rows (params, cache, batch).
    The bytes of its storages on the card must equal, byte for byte, the
    dry run's per-rank argument bytes for the same arch, depth, batch,
    sequence length and mesh; the growth of ``torch.cuda.memory_allocated``
    is printed beside them (the allocator rounds each block up to 512 B)."""
    from repro_torch.configs import at_depth, get_config, input_specs
    from repro_torch.distributed.context import Mesh
    from repro_torch.distributed.sharding import (cache_specs, local_bytes, local_of,
                                                  param_specs, place, stored_zeros)
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M
    from repro_torch.models.config import ShapeCell
    from repro_torch.training.optimizer import AdamWConfig, init_adamw
    from repro_torch.tree import leaves

    t0 = time.perf_counter()
    mesh = _ctx_mesh(torch)
    ctx = S.make_ctx(mesh)
    cfg = at_depth(get_config(ARCH), T1_DEPTH)
    dry_ctx = S.make_ctx(Mesh((1, 1), ("data", "model"), rank=0))
    for cell in (ShapeCell("T1c train", T1_SHAPE[1], T1_SHAPE[0], "train"),
                 ShapeCell("decode", CTX_PROMPT + CTX_STEPS, CTX_ROWS, "decode")):
        label = f"{ARCH} {cfg.num_layers} layers, {cell.name} {cell.global_batch} x {cell.seq_len}"
        _free(torch)
        before = torch.cuda.memory_allocated()
        zeros = {k: torch.zeros(v.shape, dtype=v.dtype, device=DEVICE)
                 for k, v in input_specs(cfg, cell).items()}
        batch, bshard = S.train_inputs(cfg, ctx, cell, zeros)
        params = place(M.init_params(cfg, seed=SEED, device=DEVICE), param_specs(cfg, ctx), mesh)
        if cell.kind == "train":
            args = [params, init_adamw(params, AdamWConfig()), place(batch, bshard, mesh)]
        else:
            n = cell.seq_len
            args = [params, stored_zeros(M.cache_shapes(cfg, cell.global_batch, n),
                                         cache_specs(cfg, ctx, cell.global_batch, n), mesh,
                                         cfg.adtype, DEVICE),
                    place(batch, bshard, mesh)]
        del zeros, batch, params
        torch.cuda.synchronize()
        grew = torch.cuda.memory_allocated() - before
        held = _storage_bytes(map(local_of, leaves(args)))
        want, _ = D.argument_bytes(D.build_cell(cfg, cell, dry_ctx)[1])
        log(f"store[{label}]: storage on the card {held} B, local_bytes {local_bytes(args)} B, "
            f"the dry run's per-rank argument bytes {want} B (mesh (1, 1)); "
            f"torch.cuda.memory_allocated grew {grew} B ({grew - held:+d} B of allocator "
            f"rounding)")
        if not held == local_bytes(args) == want:
            raise AssertionError(f"store[{label}]: {held} B on the card, the dry run says {want}")
        del args
    _free(torch)
    log(f"store phase: {time.perf_counter() - t0:.1f} s")


# ----------------------------------------------------------------------------- dry-run phase

# (arch, cell, multi-pod, depth (0: full), batch whole)
DRYRUN_CELLS = (("qwen3-30b-a3b", "decode_32k", False, 0, False),
                ("qwen3-30b-a3b", "decode_32k", True, 0, False),
                ("qwen3-30b-a3b", "train_4k", False, 0, False),
                ("qwen3-30b-a3b", "train_4k", True, 0, False),
                ("qwen2-72b", "train_4k", False, 0, False))
# cells run twice at depth 4 on 16 x 16: the batch in blocks over "data"
# and whole on every rank, and the least factor a rank's FLOPs must fall by:
# 8 (half of dp = 16), or in qwen3's decode 7, because there the MoE
# capacity's floor of 8 rows a slot (both packages) gives a rank's 8 tokens
# half the expert rows of the whole batch's 128, not 1/16: the dense work
# falling 16x and the experts' 2x predict 7.58x (PERF.md §6), and an
# expert FFN on the whole batch's rows (4.74x) or dense work falling 8x
# (5.42x) stays below 7
DRYRUN_PAIRS = (("qwen3-30b-a3b", "train_4k", 8.0), ("qwen3-30b-a3b", "decode_32k", 7.0))
# qwen3 train_4k at depth 4 on 16 x 16, batch in blocks: FLOPs a rank with
# every layer whole over "model" (the dry run's record before the layers
# computed on their "model" blocks), and the least factor they must fall by
DRYRUN_WHOLE_MODEL_FLOPS = 2.3905e14
DRYRUN_MODEL_AXIS_FALL = 4.0


def _dryrun_name(arch, cell, multi_pod, depth, whole) -> str:
    return (f"{arch}__{cell}__{'2x16x16' if multi_pod else '16x16'}"
            + (f"__depth{depth}" if depth else "") + ("__batch-whole" if whole else ""))


def dryrun_phase(torch) -> None:
    """``python -m repro_torch.launch.dryrun`` as a user runs it, one
    subprocess a cell, all started together (each starts the fake group of
    its 256 or 512 ranks in its own process): the full-depth cells, and
    each of DRYRUN_PAIRS at depth 4 with the batch in blocks and with
    ``--batch-whole``.  Each must exit 0; its record's per-rank argument
    bytes, peak, FLOPs and collective bytes are printed beside the card's
    memory; each pair's FLOPs a rank must fall at least its factor in
    DRYRUN_PAIRS with the batch in blocks, and qwen3
    train_4k's at depth 4 at least DRYRUN_MODEL_AXIS_FALL times below
    DRYRUN_WHOLE_MODEL_FLOPS."""
    t0 = time.perf_counter()
    out = ROOT / "build" / "dryrun"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    card = torch.cuda.get_device_properties(0).total_memory
    runs = list(DRYRUN_CELLS) + [(a, c, False, 4, w) for a, c, _ in DRYRUN_PAIRS
                                 for w in (False, True)]
    procs = []
    for arch, cell, multi_pod, depth, whole in runs:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--cell",
               cell, "--out", str(out)] + (["--multi-pod"] if multi_pod else []) \
            + (["--depth", str(depth)] if depth else []) + (["--batch-whole"] if whole else [])
        procs.append(((arch, cell, multi_pod, depth, whole), time.perf_counter(),
                      subprocess.Popen(cmd, cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    failed, recs = [], {}
    for key, t1, proc in procs:
        try:
            text, _ = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        wall = time.perf_counter() - t1
        name = _dryrun_name(*key)
        if proc.returncode != 0:
            failed.append((name, proc.returncode))
            log(f"dryrun[{name}]: exit {proc.returncode}\n{text[-3000:]}")
            continue
        rec = recs[key] = json.loads((out / f"{name}.json").read_text())
        mem = rec["memory_analysis"]
        log(f"dryrun[{name}]: exit 0 in {wall:.1f} s wall; per rank: argument "
            f"{mem['argument_size_in_bytes']} B, output {mem['output_size_in_bytes']} B, peak "
            f"{mem['peak_size_in_bytes']} B ({mem['peak_size_in_bytes'] / card:.2f}x the card's "
            f"{card} B), {rec['flops_per_dev']:.4e} FLOPs, collective wire bytes "
            f"{rec['collective_bytes_per_dev']:.6e} ({rec['collectives']['counts']}), "
            f"dominant {rec['dominant']}")
    for arch, cell, gate in DRYRUN_PAIRS:
        blocks, whole = (recs.get((arch, cell, False, 4, w)) for w in (False, True))
        if blocks is None or whole is None:
            continue
        fell = whole["flops_per_dev"] / max(blocks["flops_per_dev"], 1)
        peak = (whole["memory_analysis"]["peak_size_in_bytes"]
                / max(blocks["memory_analysis"]["peak_size_in_bytes"], 1))
        log(f"dryrun[{arch} {cell} 16x16 depth 4]: the batch in blocks over \"data\" against "
            f"whole on every rank: FLOPs a rank {blocks['flops_per_dev']:.4e} against "
            f"{whole['flops_per_dev']:.4e} ({fell:.2f}x fewer, gate {gate}x), peak "
            f"{peak:.2f}x lower")
        if not fell >= gate:
            failed.append((f"{arch} {cell}: batch blocks cut FLOPs {fell:.2f}x", None))
    blocks = recs.get(("qwen3-30b-a3b", "train_4k", False, 4, False))
    if blocks is not None:
        fell = DRYRUN_WHOLE_MODEL_FLOPS / max(blocks["flops_per_dev"], 1.0)
        log(f"dryrun[qwen3-30b-a3b train_4k 16x16 depth 4]: the model axis: FLOPs a rank "
            f"{blocks['flops_per_dev']:.4e} against {DRYRUN_WHOLE_MODEL_FLOPS:.4e} with every "
            f"layer whole over \"model\" ({fell:.2f}x fewer, gate {DRYRUN_MODEL_AXIS_FALL}x)")
        if not fell >= DRYRUN_MODEL_AXIS_FALL:
            failed.append((f"qwen3-30b-a3b train_4k: the model axis cut FLOPs {fell:.2f}x",
                           None))
    log(f"dryrun phase: {time.perf_counter() - t0:.1f} s")
    if failed:
        raise AssertionError(f"dryrun phase: {failed}")


# ----------------------------------------------------------------------------- serve phase

SERVE_RUNS = (("plain", []), ("--fail-engine 1", ["--fail-engine", "1"]))


def serve_phase() -> None:
    """``python -m repro_torch.launch.serve`` as a user runs it, in a
    subprocess on the card, with the reference's defaults (qwen3's smoke
    config, "gimbal", 2 engines, BurstGPT --n 40), plain and with
    ``--fail-engine 1``: every request must finish, and the failure must
    re-route requests."""
    import os
    import re
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for label, extra in SERVE_RUNS:
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", *extra]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if run.returncode != 0:
            raise AssertionError(f"serve[{label}]: exited {run.returncode}: "
                                 f"{run.stderr[-2000:]}")
        lines = [line for line in run.stdout.splitlines() if line.startswith("[serve]")]
        for line in lines:
            log(f"serve[{label}]: {line}")
        done = re.search(r"(\d+)/(\d+) done", run.stdout)
        moved = [int(m) for m in re.findall(r"re-routed (\d+) requests", run.stdout)]
        log(f"serve[{label}]: wall {wall:.1f} s (process start, CUDA init and the run)")
        if not done or done.group(1) != done.group(2):
            raise AssertionError(f"serve[{label}]: not every request finished: {lines}")
        if "--fail-engine" in extra and not (moved and moved[0] > 0):
            raise AssertionError(f"serve[{label}]: the failure re-routed no request: {lines}")


def _report_trace(prof, wall_s: float, label: str, seen: dict | None) -> list:
    """Device busy share over the traced run, the host's synchronising
    runtime calls (for an engine run, the stream synchronizes also net of
    the one a call that this script's finiteness checks add, over
    ``seen``'s prefill and decode calls), and the kernels that took the most device time
    (summed over launches), with the decode-attention split and merge
    passes, the router and the host-to-device copies listed wherever they
    rank."""
    from torch.autograd import DeviceType
    rows = []
    averages = prof.key_averages()
    for ev in averages:
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us, ev.count, ev.key))
    busy_ms = sum(r[0] for r in rows) / 1e3
    if busy_ms == 0:
        log(f"trace[{label}]: the profiler recorded no device time: busy share not measured")
        return rows
    log(f"trace[{label}]: wall_ms={1e3 * wall_s:.3f} device_busy_ms={busy_ms:.3f} "
        f"busy_share={busy_ms / (1e3 * wall_s):.4f} idle_share={1 - busy_ms / (1e3 * wall_s):.4f}")
    # the host's waits on the device: a copy from pageable host memory
    # (cudaMemcpyAsync) is followed by a stream synchronize
    waits = {ev.key: ev.count for ev in averages
             if ev.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                           "cudaMemcpyAsync")}
    log(f"trace[{label}]: host runtime calls {waits}")
    if seen is not None:
        calls = seen["prefill"] + seen["decode"]
        net = waits.get("cudaStreamSynchronize", 0) - calls
        log(f"trace[{label}]: cudaStreamSynchronize net of the finiteness checks {net} "
            f"over {seen['prefill']} prefills and {seen['decode']} decode steps "
            f"({net / max(calls, 1):.2f} a call)")
    gemm_ms = sum(us for us, _, key in rows if "tc_gemm_kernel" in key) / 1e3
    if gemm_ms:
        log(f"trace[{label}]: moe_gemm (tc_gemm_kernel) {gemm_ms:.3f} ms of "
            f"{busy_ms:.3f} ms device busy, share={gemm_ms / busy_ms:.4f}")
    ranked = sorted(rows, reverse=True)
    for i, (us, count, key) in enumerate(ranked):
        # the ten largest rows, and the decode-attention and router kernels
        # and the host-to-device copies wherever they rank
        if i < 10 or "rt::split::" in key or "rt::router::" in key or "HtoD" in key:
            log(f"trace[{label}]:   {us / 1e3:10.3f} ms  {count:6d} calls  {key[:90]}")
    return rows


def _check_router_trace(rows, launches: dict, label: str) -> None:
    """The traced run's router kernels: one name per instantiation that ran
    (replicated for kernel 2, identity for kernel 5), each launched once per
    wrapper call."""
    router = {key: count for _, count, key in rows if "rt::router::" in key}
    flags = (("route_kernel<true", "topk_router_replicated"),
             ("route_kernel<false", "topk_router"))
    want = {flag: launches[name] for flag, name in flags if launches[name]}
    got = {flag: [c for key, c in router.items() if flag in key] for flag, _ in flags}
    if len(router) != len(want) or any(got[flag] != [n] for flag, n in want.items()):
        raise AssertionError(f"trace[{label}]: router kernels {router} != one per wrapper "
                             f"call {want}")
    log(f"trace[{label}]: router kernels {len(router)}, launches equal to wrapper calls "
        f"{want}")


# ----------------------------------------------------------------------------- main

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import model as M
    from repro_torch.tree import leaves

    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    build_logs = _build.build_all()
    log(f"build: {len(build_logs)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    cfg = get_config(ARCH).replace(num_layers=4)
    log(f"config: {ARCH} d_model={cfg.d_model} heads={cfg.num_heads}/{cfg.num_kv_heads}x"
        f"{cfg.head_dim} experts={cfg.num_experts} top{cfg.moe_top_k} d_ff={cfg.moe_d_ff} "
        f"vocab={cfg.vocab_size} dtype={cfg.dtype}; reduced: num_layers 48 -> 4")
    timer = Timer(torch)
    kernels = kernel_phase(torch, timer, cfg)
    del timer
    torch.cuda.empty_cache()
    reference_phase(torch, cfg)

    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=SEED, device=DEVICE)
    torch.cuda.synchronize()
    log(f"params: {sum(p.numel() for p in leaves(params)) / 1e9:.3f} B parameters, "
        f"init {time.perf_counter() - t0:.3f} s")
    main_run = engine_run(torch, cfg, params, n_req=16, max_new=32, kv_quant=None,
                          label="bf16")
    engine_run(torch, cfg, params, n_req=8, max_new=16, kv_quant="int8", label="int8 KV")
    _retraced(lambda **kw: engine_run(torch, cfg, params, n_req=8, max_new=16, kv_quant=None,
                                      label="bf16 traced", **kw))
    slot_run = gimbal_run(torch, cfg, params, n_req=16, max_new=32)
    _retraced(lambda **kw: gimbal_run(torch, cfg, params, n_req=8, max_new=16,
                                      label="slot+gimbal+rep traced", **kw))
    cluster = cluster_phase(torch, cfg, params)
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del params
    torch.cuda.empty_cache()
    families = families_phase(torch)
    variants = variants_phase(torch)
    ssm = ssm_phase(torch)
    ctx = ctx_phase(torch)
    store_phase(torch)
    train = train_phase(torch)
    serve_phase()
    dryrun_phase(torch)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    # kernels 1-3 launch on the paged main path; kernels 4 and 5 in the slot
    # run, where they are driven on that run's own cache and router logits
    launches = dict(main_run["launches"], flash_decode=slot_run["launches"]["flash_decode"],
                    topk_router=slot_run["launches"]["topk_router"])
    line = []
    for name, k in kernels.items():
        line.append({"name": name, "route": "cuda", "source": k["source"],
                     "replaces": k["replaces"], "launches": launches[name],
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"], "library_ms": k["library_ms"],
                     "cluster_launches": {run: n[name] for run, n in cluster.items()},
                     "families_launches": {run: n[name] for run, n in families.items()},
                     "variants_launches": {run: n[name] for run, n in variants.items()},
                     "ssm_launches": {run: n[name] for run, n in ssm.items()},
                     "ctx_launches": {run: n[name] for run, n in ctx.items()},
                     "train_launches": {run: n[name] for run, n in train.items()}})
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
