"""The port's kernel layer on the CPU: each plain PyTorch version
(``repro_torch.kernels.ref``, which the wrappers compute for CPU tensors) is
held against the reference's Pallas kernel in interpret mode and its
``ref.py`` oracle, on the same numpy inputs.

Tolerances are the reference's own (tests/test_kernels.py): f32
rtol=atol=2e-4, bf16 5e-2; integer outputs (expert ids, slots, capacity
positions) must be exactly equal.  The CUDA kernels themselves run only on
the card and are held against these plain versions by chip_smoke.py.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_decode import flash_decode as jax_flash_decode
from repro.kernels.flash_decode import flash_decode_paged as jax_flash_decode_paged
from repro.kernels.moe_gemm import moe_gemm as jax_moe_gemm
from repro.kernels.topk_router import topk_router as jax_topk_router
from repro.kernels.topk_router import topk_router_replicated as jax_router
from repro.models.moe import ExpertPlacement as JaxPlacement
from repro.training.compression import quantize_int8 as jax_quantize_int8
from repro_torch import device as devlib
from repro_torch.kernels import (KERNELS, _build, decode_attention, flash_decode,
                                 flash_decode_paged, moe_gemm, ref,
                                 reset_launch_counts, route, topk_router,
                                 topk_router_replicated)
from repro_torch.kernels.flash_decode import CHUNK, split_plan
from repro_torch.kernels.moe_gemm import check_bf16_shapes
from repro_torch.kernels.moe_gemm import launch_plan as moe_gemm_plan
from repro_torch.kernels.topk_router import route_plan, smem_bytes
from repro_torch.models.moe import ExpertPlacement
from repro_torch.training.compression import quantize_int8

REPO = Path(__file__).resolve().parents[1]
TOL = {"float32": dict(rtol=2e-4, atol=2e-4), "bfloat16": dict(rtol=5e-2, atol=5e-2)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _as_dtype(x: np.ndarray, dtype: str) -> np.ndarray:
    """Round through the working dtype once, in JAX, and return exact f32
    values: both packages then start from identical numbers."""
    return np.array(jnp.asarray(x, dtype).astype(jnp.float32))


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch CPU tensor."""
    return jnp.asarray(x, dtype), torch.from_numpy(np.ascontiguousarray(x)).to(TORCH_DT[dtype])


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.is_floating_point() else t.numpy()
    return np.asarray(t, np.float32) if jnp.issubdtype(t.dtype, jnp.floating) else np.asarray(t)


# --- grouped expert GEMM -------------------------------------------------------

@pytest.mark.parametrize("e,c,d,f", [(2, 8, 16, 32), (4, 96, 64, 160), (1, 200, 128, 96)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gemm_plain_matches_pallas(e, c, d, f, dtype):
    rng = np.random.default_rng(e * 1000 + c)
    x = _as_dtype(rng.normal(size=(e, c, d)), dtype)
    w = _as_dtype(rng.normal(size=(e, d, f)), dtype)
    xj, xt = _pair(x, dtype)
    wj, wt = _pair(w, dtype)
    got = moe_gemm(xt, wt)
    assert got.dtype == TORCH_DT[dtype] and got.shape == (e, c, f)
    np.testing.assert_allclose(_np(got), _np(jax_moe_gemm(xj, wj, interpret=True)),
                               **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(jref.ref_moe_gemm(xj, wj)), **TOL[dtype])


@pytest.mark.parametrize("c,block_c,c_tiles,smem", [(8, 8, 1, 74_240), (48, 48, 1, 97_280),
                                                     (320, 64, 5, 106_496)])
def test_moe_gemm_bf16_launch_plan(c, block_c, c_tiles, smem):
    """The bf16 kernel's grid (F-tiles, C-tiles, E) and dynamic shared
    memory at qwen3 widths: gate/up (2048 -> 768) and down (768 -> 2048);
    C above 64 takes several C-tiles, and no plan exceeds what one H100
    block may use."""
    up = moe_gemm_plan(128, c, 2048, 768, torch.bfloat16)
    down = moe_gemm_plan(128, c, 768, 2048, torch.bfloat16)
    assert (up.block_c, up.block_f, up.block_k) == (block_c, 128, 64)
    assert up.grid == (6, c_tiles, 128) and down.grid == (16, c_tiles, 128)
    assert up.smem == down.smem == smem <= 232_448
    assert up.n_tiles == block_c // 8
    f32 = moe_gemm_plan(128, c, 2048, 768, torch.float32)     # CUDA cores, static smem
    assert (f32.block_c, f32.block_f, f32.block_k, f32.smem) == (32, 64, 32, 0)


def test_moe_gemm_bf16_rejects_rows_that_are_not_16_bytes():
    check_bf16_shapes(2048, 768)
    check_bf16_shapes(768, 2048)
    for d, f in ((2047, 768), (2048, 764), (12, 8)):
        with pytest.raises(ValueError, match="multiples of 8"):
            check_bf16_shapes(d, f)
        with pytest.raises(ValueError, match="multiples of 8"):
            moe_gemm_plan(4, 8, d, f, torch.bfloat16)
    moe_gemm_plan(4, 8, 2047, 764, torch.float32)              # f32 takes any shape


def test_moe_gemm_zero_rows_stay_zero():
    """Capacity padding rows are zero in, zero out."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 16, 32)).astype(np.float32)
    x[:, 5:] = 0
    w = rng.normal(size=(3, 32, 24)).astype(np.float32)
    out = _np(moe_gemm(torch.from_numpy(x), torch.from_numpy(w)))
    assert (out[:, 5:] == 0).all()


# --- paged flash-decode ----------------------------------------------------------

def _paged_case(seed, b, hq, hkv, d, bs, nb, dtype="float32"):
    """Random page pool + non-aliasing random block tables (page 0 reserved
    as the garbage page, like PagedKVCache)."""
    pool = b * nb + 1
    rng = np.random.default_rng(seed)
    q = _as_dtype(rng.normal(size=(b, hq, d)), dtype)
    kp = _as_dtype(rng.normal(size=(pool, bs, hkv, d)), dtype)
    vp = _as_dtype(rng.normal(size=(pool, bs, hkv, d)), dtype)
    tables = (rng.permutation(pool - 1)[:b * nb] + 1).reshape(b, nb).astype(np.int32)
    return q, kp, vp, tables


def _both_paged(q, kp, vp, tables, lengths, dtype="float32", softcap=0.0,
                k_scale=None, v_scale=None):
    """(port plain version, Pallas interpret, reference oracle) outputs."""
    lengths = np.asarray(lengths, np.int32)
    qj, qt = _pair(q, dtype)
    if kp.dtype == np.int8:
        kj, kt, vj, vt = jnp.asarray(kp), torch.from_numpy(kp), jnp.asarray(vp), torch.from_numpy(vp)
    else:
        (kj, kt), (vj, vt) = _pair(kp, dtype), _pair(vp, dtype)
    sj = dict(k_scale=None if k_scale is None else jnp.asarray(k_scale),
              v_scale=None if v_scale is None else jnp.asarray(v_scale))
    st = dict(k_scale=None if k_scale is None else torch.from_numpy(k_scale),
              v_scale=None if v_scale is None else torch.from_numpy(v_scale))
    got = flash_decode_paged(qt, kt, vt, torch.from_numpy(tables),
                             torch.from_numpy(lengths), softcap=softcap, **st)
    pallas = jax_flash_decode_paged(qj, kj, vj, jnp.asarray(tables), jnp.asarray(lengths),
                                    softcap=softcap, interpret=True, **sj)
    oracle = jref.ref_flash_decode_paged(qj, kj, vj, jnp.asarray(tables),
                                         jnp.asarray(lengths), softcap=softcap, **sj)
    return _np(got), _np(pallas), _np(oracle)


@pytest.mark.parametrize("b,hq,hkv,d,bs,nb", [(4, 4, 2, 16, 16, 4), (2, 8, 8, 32, 32, 3),
                                              (3, 4, 1, 64, 16, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_paged_plain_matches_pallas(b, hq, hkv, d, bs, nb, dtype):
    """Ragged lengths, a zero-length row and the exactly-full case: lengths
    cover {0, mid-block, block boundary, nb*bs}."""
    q, kp, vp, bt = _paged_case(b * 31 + nb, b, hq, hkv, d, bs, nb, dtype)
    lens = np.linspace(0, nb * bs, b).astype(np.int32)
    lens[b // 2] = bs
    got, pallas, oracle = _both_paged(q, kp, vp, bt, lens, dtype)
    np.testing.assert_allclose(got, pallas, **TOL[dtype])
    np.testing.assert_allclose(got, oracle, **TOL[dtype])
    assert (got[lens == 0] == 0).all()       # length 0 attends to nothing: exact zeros


def test_flash_decode_paged_single_block_pages():
    q, kp, vp, bt = _paged_case(7, 3, 4, 2, 16, 16, 1)
    got, pallas, oracle = _both_paged(q, kp, vp, bt, [16, 1, 9])
    np.testing.assert_allclose(got, pallas, **TOL["float32"])
    np.testing.assert_allclose(got, oracle, **TOL["float32"])


def test_flash_decode_paged_softcap():
    q, kp, vp, bt = _paged_case(11, 2, 4, 2, 16, 16, 4)
    got, pallas, oracle = _both_paged(q * 10, kp, vp, bt, [40, 64], softcap=30.0)
    np.testing.assert_allclose(got, pallas, **TOL["float32"])
    np.testing.assert_allclose(got, oracle, **TOL["float32"])


# --- slot-cache flash-decode ---------------------------------------------------------

def _slot_case(seed, b, s, hq, hkv, d, dtype="float32"):
    rng = np.random.default_rng(seed)
    return (_as_dtype(rng.normal(size=(b, hq, d)), dtype),
            _as_dtype(rng.normal(size=(b, s, hkv, d)), dtype),
            _as_dtype(rng.normal(size=(b, s, hkv, d)), dtype))


def _both_slot(q, k, v, lengths, dtype="float32", softcap=0.0, block_s=256):
    """(port plain version, Pallas interpret, reference oracle) outputs."""
    lengths = np.asarray(lengths, np.int32)
    (qj, qt), (kj, kt), (vj, vt) = _pair(q, dtype), _pair(k, dtype), _pair(v, dtype)
    got = flash_decode(qt, kt, vt, torch.from_numpy(lengths), softcap=softcap)
    assert got.dtype == TORCH_DT[dtype] and got.shape == q.shape
    pallas = jax_flash_decode(qj, kj, vj, jnp.asarray(lengths), block_s=block_s,
                              softcap=softcap, interpret=True)
    oracle = jref.ref_flash_decode(qj, kj, vj, jnp.asarray(lengths), softcap)
    return _np(got), _np(pallas), _np(oracle)


@pytest.mark.parametrize("b,s,hq,hkv,d,block_s", [(4, 64, 4, 2, 16, 16), (3, 100, 8, 8, 32, 32),
                                                  (5, 48, 8, 1, 64, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_plain_matches_pallas(b, s, hq, hkv, d, block_s, dtype):
    """Ragged lengths that are multiples of no tile, a zero-length row, a
    one-token row and the full cache; S=100 leaves the Pallas kernel a
    padded last block."""
    q, k, v = _slot_case(b * 7 + s, b, s, hq, hkv, d, dtype)
    lens = np.linspace(0, s, b).astype(np.int32)
    lens[1] = 1
    got, pallas, oracle = _both_slot(q, k, v, lens, dtype, block_s=block_s)
    np.testing.assert_allclose(got, pallas, **TOL[dtype])
    np.testing.assert_allclose(got, oracle, **TOL[dtype])
    assert (got[lens == 0] == 0).all()       # length 0 attends to nothing: exact zeros


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_softcap(dtype):
    """q scaled by 10 so that the scores reach where the cap bends them."""
    q, k, v = _slot_case(13, 3, 64, 8, 2, 32, dtype)
    lens = [0, 37, 64]
    got, pallas, oracle = _both_slot(q * 10, k, v, lens, dtype, softcap=30.0, block_s=32)
    np.testing.assert_allclose(got, pallas, **TOL[dtype])
    np.testing.assert_allclose(got, oracle, **TOL[dtype])
    assert (got[0] == 0).all()
    uncapped, _, _ = _both_slot(q * 10, k, v, lens, dtype, softcap=0.0, block_s=32)
    assert np.abs(uncapped - got).max() > 1e-2           # the cap changes the answer


def test_decode_attention_entry_point_is_the_kernel_wrapper():
    q, k, v = _slot_case(3, 2, 32, 4, 2, 16)
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    lens = torch.tensor([5, 32], dtype=torch.int64)        # ops casts to int32
    torch.testing.assert_close(decode_attention(*args, lens, softcap=5.0),
                               ref.ref_flash_decode(*args, lens.int(), 5.0))


# --- the slot kernel's split-and-merge arithmetic -------------------------------------

@pytest.mark.parametrize("chunk,s", [(16, 40), (CHUNK, 2 * CHUNK + 2)])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_merge_mirror_matches_plain_and_pallas(chunk, s, softcap, dtype):
    """The plain mirror of the split pass (per-chunk partials) and merge
    (log-sum-exp) against the one-pass plain version and the Pallas kernel,
    at lengths 0, 1, CH-1, CH, CH+1 and S; length 0 gives exact zeros."""
    lens = np.array([0, 1, chunk - 1, chunk, chunk + 1, s], np.int32)
    q, k, v = _slot_case(chunk + s, len(lens), s, 8, 2, 32, dtype)
    q = q * 10 if softcap else q
    got, pallas, oracle = _both_slot(q, k, v, lens, dtype, softcap=softcap, block_s=32)
    (_, qt), (_, kt), (_, vt) = _pair(q, dtype), _pair(k, dtype), _pair(v, dtype)
    split = _np(ref.ref_flash_decode_split(qt, kt, vt, torch.from_numpy(lens), softcap, chunk))
    for want in (got, pallas, oracle):
        np.testing.assert_allclose(split, want, **TOL[dtype])
    assert (split[0] == 0).all()


def test_split_partials_merge_faults_are_visible():
    """What the merge must not do: drop a row's last partial chunk, or add
    the partials without the e^(m_i - M) rescale, each moves the output
    well past the f32 tolerance; an empty row has no valid chunk."""
    lens = np.array([0, 5, 33, 64], np.int32)
    q, k, v = (torch.from_numpy(a) for a in _slot_case(21, 4, 64, 4, 2, 16))
    m, l, acc, valid = ref.ref_flash_decode_partials(q * 4, k, v, torch.from_numpy(lens),
                                                     chunk=16)
    assert valid.sum(-1).tolist() == [0, 1, 3, 4]
    want = ref.ref_flash_decode(q * 4, k, v, torch.from_numpy(lens))
    torch.testing.assert_close(ref.ref_merge_partials(m, l, acc, valid), want,
                               **TOL["float32"])
    last = valid.long().cumsum(-1) == valid.sum(-1, keepdim=True)
    dropped = ref.ref_merge_partials(m, l, acc, valid & ~last)
    vm = valid[:, None, :, None]
    no_rescale = (torch.where(vm, acc, 0.0).sum(-2)
                  / torch.where(vm[..., 0], l, 0.0).sum(-1, keepdim=True).clamp(min=1e-20))
    for bad in (dropped, no_rescale):
        assert (bad[1:] - want[1:]).abs().max() > 1e-2
    assert (dropped[0] == 0).all() and (no_rescale[0] == 0).all()


def test_flash_decode_split_plan():
    """1024 split-pass blocks at the slot path's shape (B=8, S=1024, 4 KV
    heads x 128, bf16) with one chunk each; wider batches take several
    chunks per block so the scratch stays bounded; head dims that are not
    whole 16-byte vectors raise."""
    assert CHUNK == 32
    plan = split_plan(8, 1024, 32, 4, 128, 2)
    assert (plan.n_split, plan.chunks_per_split, plan.span) == (32, 1, CHUNK)
    assert 8 * 4 * plan.n_split == 1024
    assert plan.scratch_floats * 4 == 8 * 32 * 32 * 130 * 4 == 4_259_840
    wide = split_plan(64, 1024, 32, 4, 128, 2)
    assert (wide.n_split, wide.chunks_per_split) == (5, 7)
    assert wide.n_split * wide.span >= 1024 > (wide.n_split - 1) * wide.span
    long = split_plan(8, 32768, 32, 4, 128, 2)
    assert long.n_split * long.span >= 32768 and long.n_split <= 33
    assert split_plan(8, 0, 32, 4, 128, 2).n_split == 1
    assert split_plan(8, 1024, 32, 4, 128, 4).n_split == 32          # f32, same cut
    split_plan(8, 1024, 32, 4, 120, 2)                               # 15 vectors a row
    for d, item in ((12, 2), (6, 4), (0, 2)):
        with pytest.raises(ValueError, match="head dim"):
            split_plan(8, 1024, 32, 4, d, item)


# --- the paged kernel's split-and-merge arithmetic -------------------------------------

PAGED_PAIRS = [("float32", False), ("bfloat16", False), ("float32", True), ("bfloat16", True)]


def _paged_split(q, kp, vp, bt, lens, softcap=0.0, **scales):
    """The paged mirror's partials, merged: the kernel's arithmetic."""
    parts = ref.ref_flash_decode_paged_partials(q, kp, vp, bt, lens, softcap, **scales)
    return ref.ref_merge_partials(*parts).to(q.dtype)


@pytest.mark.parametrize("bs", [8, 16, 32, 48])
@pytest.mark.parametrize("dtype,int8", PAGED_PAIRS)
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_flash_decode_paged_split_mirror_matches_pallas(bs, dtype, int8, softcap):
    """The plain mirror of the paged split pass (32-position chunks through
    the block table, per-page int8 scales on the score and the P.V weights)
    merged, against the plain version, the Pallas kernel and its oracle.
    Pages of 8, 16, 32 and 48 positions: smaller than, equal to, larger
    than and not a divisor of a chunk.  Rows: length 0, 1, one past a page,
    one past a chunk, the whole table, and a free row (length 1, all-zero
    table row) that reads the garbage page 0."""
    nb = -(-(2 * CHUNK + 8) // bs)
    q, kp, vp, bt = _paged_case(bs + nb, 6, 8, 2, 32, bs, nb, dtype)
    bt[5] = 0
    lens = np.array([0, 1, bs + 1, CHUNK + 1, nb * bs, 1], np.int32)
    q = q * 10 if softcap else q
    scales = {}
    if int8:
        (kp, ks), (vp, vs) = _int8_pages(kp), _int8_pages(vp)
        scales = dict(k_scale=ks, v_scale=vs)
    got, pallas, oracle = _both_paged(q, kp, vp, bt, lens, dtype, softcap, **scales)
    qt = _pair(q, dtype)[1]
    kt, vt = ((torch.from_numpy(x) if int8 else _pair(x, dtype)[1]) for x in (kp, vp))
    st = {k: torch.from_numpy(v) for k, v in scales.items()}
    split = _paged_split(qt, kt, vt, torch.from_numpy(bt), torch.from_numpy(lens), softcap,
                         **st)
    assert split.dtype == TORCH_DT[dtype] and split.shape == q.shape
    split = _np(split)
    for want in (got, pallas, oracle):
        np.testing.assert_allclose(split, want, **TOL[dtype])
    assert (split[0] == 0).all()             # length 0 attends to nothing: exact zeros


def test_flash_decode_paged_split_clamps_lengths_to_the_table():
    """A length past NB * BS attends to the whole table, as the plain
    version does."""
    q, kp, vp, bt = (torch.from_numpy(a) for a in _paged_case(5, 2, 4, 2, 16, 16, 3))
    lens = torch.tensor([48, 1000], dtype=torch.int32)
    want = ref.ref_flash_decode_paged(q, kp, vp, bt, torch.tensor([48, 48], dtype=torch.int32))
    torch.testing.assert_close(_paged_split(q, kp, vp, bt, lens), want, **TOL["float32"])


@pytest.mark.parametrize("int8", [False, True])
def test_paged_fault_checks_fall_outside_the_gate(int8):
    """chip_smoke.py's wrong answers for the paged kernel (length mask to
    the page or chunk end, merge faults, contiguous pages within a chunk,
    and for int8 one scale per chunk or the V scale inside l) each fall
    outside its f32 gate at a small shape, and the mirror falls inside."""
    import chip_smoke
    q, kp, vp, bt = _paged_case(9, 4, 8, 2, 32, 16, 8)
    args = [torch.from_numpy(a) for a in (q * 4, kp, vp, bt)]
    kw = dict(k_scale=None, v_scale=None, softcap=0.0)
    if int8:
        (kq, ks), (vq, vs) = _int8_pages(kp), _int8_pages(vp)
        args[1:3] = torch.from_numpy(kq), torch.from_numpy(vq)
        kw.update(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    args.append(torch.tensor([0, 17, 75, 128], dtype=torch.int32))
    rtol, atol = chip_smoke.FD_TOL["float32"]
    want = ref.ref_flash_decode_paged(*args, **kw)
    assert chip_smoke.max_excess(_paged_split(*args, **kw), want, rtol, atol)[1] <= 0
    wrong = chip_smoke._paged_faults(torch, ref, args, kw, CHUNK)
    assert len(wrong) == (7 if int8 else 5)
    for fault, bad in wrong.items():
        assert chip_smoke.max_excess(bad, want, rtol, atol)[1] > 0, fault


def test_flash_decode_paged_split_plan():
    """The paged path's shape (B = 8, NB * BS = 64 * 16 = 1024, 4 KV heads
    x 128) gets 1024 split-pass blocks of one chunk each, from shapes alone,
    whatever the pages' itemsize (bf16, f32 or int8)."""
    for item in (2, 4, 1):
        plan = split_plan(8, 64 * 16, 32, 4, 128, item)
        assert (plan.n_split, plan.chunks_per_split, plan.span) == (32, 1, CHUNK)
        assert 8 * 4 * plan.n_split == 1024
    assert split_plan(8, 22 * 48, 32, 4, 128, 2).n_split == 33       # 48-position pages
    with pytest.raises(ValueError, match="head dim"):
        split_plan(8, 1024, 32, 4, 8, 1)                             # 8 B rows of int8


def _int8_pages(pages: np.ndarray):
    """Per-page int8 quantisation with the reference's quantize_int8."""
    import jax
    P = pages.shape[0]
    q, scale = jax.vmap(jax_quantize_int8)(jnp.asarray(pages).reshape(P, -1))
    return np.array(q).reshape(pages.shape), np.array(scale).reshape(P)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_paged_int8_pages(dtype):
    q, kp, vp, bt = _paged_case(17, 4, 8, 2, 32, 16, 4, dtype)
    kq, ksc = _int8_pages(kp)
    vq, vsc = _int8_pages(vp)
    got, pallas, oracle = _both_paged(q, kq, vq, bt, [0, 16, 33, 64], dtype,
                                      k_scale=ksc, v_scale=vsc)
    np.testing.assert_allclose(got, pallas, **TOL[dtype])
    np.testing.assert_allclose(got, oracle, **TOL[dtype])
    assert (got[0] == 0).all()


def test_quantize_int8_matches_reference():
    import jax
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(6, 40)) * 3).astype(np.float32)
    x[2] = 0.0                                   # all-zero rows keep the 1e-12 floor
    qj, sj = jax.vmap(jax_quantize_int8)(jnp.asarray(x))
    qt, st = torch.vmap(quantize_int8)(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


# --- replica-aware router ------------------------------------------------------------

def _router_both(logits: np.ndarray, k: int, inv=None, block_t: int = 64):
    t, e = logits.shape
    inv = np.arange(e, dtype=np.int32) if inv is None else np.asarray(inv, np.int32)
    pj = JaxPlacement.from_slot_map(jnp.asarray(inv), e)
    pt = ExpertPlacement.from_slot_map(inv, e, device="cpu")
    for a, b_ in zip(pt, pj):                    # the placement tables themselves
        np.testing.assert_array_equal(a.numpy(), np.asarray(b_))
    got = topk_router_replicated(torch.from_numpy(logits), k, pt.replica_slots,
                                 pt.replica_count, len(inv))
    pallas = jax_router(jnp.asarray(logits), k, pj.replica_slots, pj.replica_count,
                        len(inv), block_t=block_t, interpret=True)
    oracle = jref.ref_topk_router_replicated(jnp.asarray(logits), k, pj.replica_slots,
                                             pj.replica_count, len(inv))
    for want in (pallas, oracle):
        np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=1e-5, atol=1e-6)
        for g_, w_ in zip(got[1:], want[1:]):
            assert g_.dtype == torch.int32
            np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
    # the slot choice IS the placement's dispatch rule
    np.testing.assert_array_equal(got[2].numpy(), pt.dispatch_slots(got[1]).numpy())
    return got


@pytest.mark.parametrize("t,e,k", [(64, 8, 1), (500, 16, 2), (128, 128, 6)])
def test_router_identity_tables(t, e, k):
    rng = np.random.default_rng(t + e)
    _router_both((rng.normal(size=(t, e)) * 2).astype(np.float32), k)


def _replicated_slot_map(rng, e: int, r: int) -> np.ndarray:
    """Every expert in >= 1 slot plus r replicas of random experts, shuffled."""
    return rng.permutation(np.concatenate([np.arange(e), rng.choice(e, r)])).astype(np.int32)


@pytest.mark.parametrize("t,e,k,r", [(64, 8, 2, 2), (300, 16, 4, 8), (96, 128, 8, 8)])
def test_router_replicated_slot_map(t, e, k, r):
    rng = np.random.default_rng(t * e + r)
    inv = _replicated_slot_map(rng, e, r)
    got = _router_both((rng.normal(size=(t, e)) * 2).astype(np.float32), k, inv)
    assert len(set(got[2].numpy().ravel()) - set(range(e + r))) == 0


@pytest.mark.parametrize("inv", [None, "replicated"])
def test_router_tied_logits_break_to_lowest_index(inv):
    """Logits rounded to multiples of 0.5 over few distinct values: many
    exactly equal probabilities, which must go to the lowest expert id in
    every implementation."""
    rng = np.random.default_rng(5)
    t, e, k = 200, 16, 4
    logits = (np.round(rng.normal(size=(t, e)) * 2) / 2).clip(-1, 1).astype(np.float32)
    assert any(len(set(row)) < e - 4 for row in logits)            # ties present
    slot_map = _replicated_slot_map(rng, e, 4) if inv else None
    got = _router_both(logits, k, slot_map, block_t=32)
    ids = got[1].numpy()
    probs = torch.softmax(torch.from_numpy(logits), -1).numpy()
    for row_p, row_i in zip(probs, ids):
        for j in range(1, k):                     # equal values in increasing id order
            if row_p[row_i[j]] == row_p[row_i[j - 1]]:
                assert row_i[j] > row_i[j - 1]


def test_router_positions_count_across_tokens():
    """Positions keep counting across all T tokens, per physical slot."""
    t, e = 256, 4
    logits = np.zeros((t, e), np.float32)
    logits[:, 0] = 10.0
    _, ids, _, pos = _router_both(logits, 1, block_t=64)
    assert (ids.numpy() == 0).all()
    np.testing.assert_array_equal(pos.numpy().ravel(), np.arange(t))


# --- the router kernel's launch plan and its cluster count ---------------------------------

def _skewed_logits(rng, t: int, e: int, hot=(1, None)) -> np.ndarray:
    """One hot expert a token: even tokens put ``hot[0]`` first and
    ``hot[1]`` second, odd tokens the other way round, so one slot's
    selections span every warp, CTA and round of a plan."""
    hot = (hot[0], e - 2 if hot[1] is None else hot[1])
    x = (rng.normal(size=(t, e)) * 2).astype(np.float32)
    even = np.arange(t) % 2 == 0
    x[:, hot[0]] = np.where(even, 20.0, 16.0)
    x[:, hot[1]] = np.where(even, 16.0, 20.0)
    return x


def _hot_slot_map(rng, e: int, r: int) -> np.ndarray:
    """Every expert once, expert 1 (the first hot one) twice more and
    r - 2 random others once more, shuffled: S = E + r."""
    extra = [1, 1, *rng.choice(np.arange(2, e - 2), r - 2, replace=False)]
    return rng.permutation(np.concatenate([np.arange(e), extra])).astype(np.int32)


@pytest.mark.parametrize("t", [1, 7, 8, 9, 16, 100, 512, 513, 1024, 5000])
def test_route_plan_lays_every_token_out_once_in_token_major_order(t):
    """Every token in exactly one (round, CTA, warp, place in warp), the
    lexicographic order of those equal to token order, one round up to 1024
    tokens (decode and every prefill bucket), at most 8 CTAs and 227 KB of
    shared memory, for E in {8, 128, 160}, k in {1, 2, 6, 8}, S up to E + 8."""
    for e in (8, 128, 160):
        for k in (1, 2, 6, 8):
            for s in (e, e + 4, e + 8):
                plan = route_plan(t, e, k, s)
                n, w, m, rounds, smem = plan
                assert 1 <= n <= 8 and 1 <= w <= 32 and m >= 1
                assert smem == smem_bytes(w, m, k, e, s) <= 232_448
                assert rounds * n * w * m >= t > (rounds - 1) * n * w * m
                if t <= 1024:
                    assert rounds == 1
                i = np.arange(t)
                where = np.stack([i // (n * w * m), i // (w * m) % n, i // m % w, i % m], 1)
                assert len({tuple(x) for x in where}) == t
                assert (where < [rounds, n, w, m]).all()
                flat = ((where[:, 0] * n + where[:, 1]) * w + where[:, 2]) * m + where[:, 3]
                np.testing.assert_array_equal(flat, i)     # token-major, contiguous
    assert route_plan(8, 128, 8, 132)[:4] == (1, 8, 1, 1)  # decode: one CTA, a token a warp
    assert route_plan(5000, 128, 8, 136).rounds == 2


def test_route_plan_overrides_and_limits():
    plan = route_plan(600, 128, 8, 136, ctas=3, warps=5, per_warp=3)
    assert plan[:4] == (3, 5, 3, 14)
    assert route_plan(1024, 128, 8, 136, ctas=1).rounds == 2
    with pytest.raises(ValueError):
        route_plan(8, 128, 17, 136)                        # k above the kernel's 16
    with pytest.raises(ValueError):
        route_plan(8, 300, 8, 300)                         # E above 8 probabilities a lane
    with pytest.raises(ValueError):
        route_plan(8, 128, 8, 136, ctas=9)                 # beyond the portable cluster
    with pytest.raises(ValueError):
        route_plan(4096, 128, 16, 4000, warps=32, per_warp=16)   # shared memory


_PLANS = (None, dict(ctas=2, warps=3, per_warp=4), dict(ctas=3, warps=2, per_warp=2),
          dict(ctas=8, warps=1, per_warp=1))


@pytest.mark.parametrize("t,e,k,r", [(200, 8, 2, 4), (90, 8, 8, 3), (64, 128, 1, 8),
                                     (96, 128, 8, 8), (150, 160, 6, 8)])
def test_router_plan_positions_match_pallas(t, e, k, r):
    """The plain mirror of the kernel's count (per warp, per CTA, across the
    cluster, carried across rounds) equals the one-hot cumsum, the plain
    router and the Pallas kernel in interpret mode, with a replicated map
    and skewed logits, under the default plan and plans with several CTAs
    and rounds."""
    rng = np.random.default_rng(t * e + k)
    inv = _hot_slot_map(rng, e, r)
    got = _router_both(_skewed_logits(rng, t, e), k, inv)
    slots, pos = got[2], got[3]
    np.testing.assert_array_equal(ref.slot_positions(slots, len(inv)).numpy(), pos.numpy())
    rounds = set()
    for over in _PLANS:
        plan = route_plan(t, e, k, len(inv), **(over or {}))
        rounds.add(plan.rounds)
        terms = ref.ref_router_plan_terms(slots, plan, len(inv))
        np.testing.assert_array_equal(ref.ref_router_plan_positions(slots, plan, len(inv)),
                                      pos.numpy())
        if plan.ctas > 1:
            assert terms["lower_ctas"].max() > 0
    assert max(rounds) > 1


@pytest.mark.parametrize("tables", ["identity", "replicated"])
def test_router_count_faults_fall_outside_the_gate(tables):
    """chip_smoke.py's four wrong counts (carry dropped across rounds, no
    lower-CTA sum, selection-major order, replica index from j) each differ
    from the plain router on skewed logits under a plan with several CTAs
    and rounds; the replica fault needs replica tables to differ."""
    import chip_smoke
    rng = np.random.default_rng(11)
    t, e, k = 120, 16, 4
    inv = _hot_slot_map(rng, e, 6) if tables == "replicated" else np.arange(e, dtype=np.int32)
    plc = ExpertPlacement.from_slot_map(inv, e, device="cpu")
    logits = torch.from_numpy(_skewed_logits(rng, t, e))
    _, ids, slots, pos = topk_router_replicated(logits, k, plc.replica_slots,
                                                plc.replica_count, len(inv))
    plan = route_plan(t, e, k, len(inv), ctas=3, warps=2, per_warp=4)
    assert plan.rounds > 1
    wrong = chip_smoke._router_faults(torch, ref, (ids, slots, pos), plc, plan, len(inv), k)
    assert len(wrong) == 4
    for fault, (fs, fp) in wrong.items():
        differs = not (torch.equal(fs, slots) and torch.equal(fp, pos))
        assert differs == (fault != "replica index from j" or tables == "replicated"), fault


def test_router_trace_check_wants_one_kernel_per_call():
    """chip_smoke.py's traced-run check: one router kernel name per
    instantiation that ran, launched once per wrapper call; two names (a
    second launch a call) or a count off the calls fail."""
    import chip_smoke
    launches = {"topk_router_replicated": 116, "topk_router": 0}
    one = [(900.0, 116, "void rt::router::route_kernel<true, 4>(float const*)")]
    chip_smoke._check_router_trace(one, launches, "test")
    for rows in (one + [(100.0, 116, "void rt::router::position_kernel(int const*)")],
                 [(900.0, 232, one[0][2])], []):
        with pytest.raises(AssertionError):
            chip_smoke._check_router_trace(rows, launches, "test")
    both = one + [(50.0, 3, "void rt::router::route_kernel<false, 4>(float const*)")]
    chip_smoke._check_router_trace(both, dict(launches, topk_router=3), "test")


def test_device_rows_retakes_only_empty_traces(monkeypatch):
    """chip_smoke.py's ``Timer.device_rows`` takes a trace again, after a
    growing pause, when it holds no device event at all (the profiler's
    own fault), up to PROFILE_ATTEMPTS traces; a trace that shows the L2
    flushes but no kernel of the call is kept, so a kernel that never
    launched still fails the one-launch-a-call check."""
    import types
    import chip_smoke
    from torch.autograd import DeviceType

    def ev(key, count):
        return types.SimpleNamespace(key=key, count=count, device_type=DeviceType.CUDA,
                                     self_device_time_total=10.0 * count)

    flush = ev("void at::native::FillFunctor<float>", 5)
    router = ev("void rt::router::route_kernel<true, 4>(float const*)", 5)
    traces = []

    class FakeProfile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return traces.pop(0)

    pauses = []
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke.time, "sleep", pauses.append)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    timer = chip_smoke.Timer(torch)
    calls = []
    traces[:] = [[], [], [flush, router]]
    assert timer.device_rows(lambda: calls.append(1), iters=5) == [(router.key, 10.0, 5)]
    assert len(calls) == 1 + 3 * 5 and not traces and pauses == [1, 2]
    traces[:] = [[flush], [flush, router]]
    assert timer.device_rows(lambda: None, iters=5) == [] and len(traces) == 1
    traces[:] = [[]] * chip_smoke.PROFILE_ATTEMPTS + [[flush, router]]
    assert timer.device_rows(lambda: None, iters=5) == [] and len(traces) == 1
    assert pauses == [1, 2, 1, 2, 4, 8]


def test_traced_runs_are_run_again_only_on_empty_traces(monkeypatch):
    """chip_smoke.py's ``_retraced`` runs a traced engine run again, after a
    growing pause, while its trace holds no device event (``EmptyTrace``),
    up to PROFILE_ATTEMPTS runs; any other failed check is raised at once."""
    import chip_smoke
    pauses, runs = [], []
    monkeypatch.setattr(chip_smoke.time, "sleep", pauses.append)

    def run(outcomes):
        def once(trace):
            assert trace is True
            runs.append(1)
            out = outcomes.pop(0)
            if isinstance(out, Exception):
                raise out
            return out
        return once

    empty = chip_smoke.EmptyTrace("trace[test]: the profiler recorded no device event")
    assert chip_smoke._retraced(run([empty, empty, "done"])) == "done"
    assert len(runs) == 3 and pauses == [1, 2]
    with pytest.raises(AssertionError, match="launches"):
        chip_smoke._retraced(run([AssertionError("launches differ"), "done"]))
    assert len(runs) == 4
    with pytest.raises(chip_smoke.EmptyTrace):
        chip_smoke._retraced(run([empty] * chip_smoke.PROFILE_ATTEMPTS))
    assert len(runs) == 4 + chip_smoke.PROFILE_ATTEMPTS


# --- identity-placement router -----------------------------------------------------------

def _topk_both(logits: np.ndarray, k: int, block_t: int = 64):
    got = topk_router(torch.from_numpy(logits), k)
    pallas = jax_topk_router(jnp.asarray(logits), k, block_t=block_t, interpret=True)
    oracle = jref.ref_topk_router(jnp.asarray(logits), k)
    for want in (pallas, oracle):
        np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=1e-5, atol=1e-6)
        for g_, w_ in zip(got[1:], want[1:]):
            assert g_.dtype == torch.int32
            np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
    return got


@pytest.mark.parametrize("t,e,k", [(8, 128, 8), (512, 128, 8), (100, 16, 3)])
@pytest.mark.parametrize("tied", [False, True])
def test_topk_router_plain_matches_pallas(t, e, k, tied):
    """Tied cases round the logits to multiples of 0.5 in [-1, 1]: many
    equal probabilities, which go to the lowest expert id everywhere."""
    rng = np.random.default_rng(t + e + k)
    logits = (rng.normal(size=(t, e)) * 2).astype(np.float32)
    if tied:
        logits = (np.round(logits) / 2).clip(-1, 1).astype(np.float32)
    got = _topk_both(logits, k, block_t=32)
    # the identity router is the replicated one with identity tables
    plc = ExpertPlacement.identity(e)
    rep = topk_router_replicated(torch.from_numpy(logits), k, plc.replica_slots,
                                 plc.replica_count, e)
    for g_, w_ in zip(got, (rep[0], rep[1], rep[3])):
        torch.testing.assert_close(g_, w_, rtol=0, atol=0)


def test_route_entry_point_counts_positions_per_expert():
    t, e = 96, 4
    logits = np.zeros((t, e), np.float32)
    logits[:, 2] = 10.0
    gates, ids, pos = route(torch.from_numpy(logits), 1)
    assert (ids.numpy() == 2).all()
    np.testing.assert_array_equal(pos.numpy().ravel(), np.arange(t))
    torch.testing.assert_close(gates, torch.ones((t, 1)))


# --- wrappers: plain path on the CPU, never a silent fallback -------------------------

def test_cpu_tensors_take_the_plain_path_without_launching():
    reset_launch_counts()
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 8, 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(2, 16, 24)).astype(np.float32))
    torch.testing.assert_close(moe_gemm(x, w), ref.ref_moe_gemm(x, w))
    q, kp, vp, bt = _paged_case(2, 2, 4, 2, 16, 16, 2)
    args = (torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(bt), torch.tensor([5, 32], dtype=torch.int32))
    torch.testing.assert_close(flash_decode_paged(*args), ref.ref_flash_decode_paged(*args))
    logits = torch.from_numpy(rng.normal(size=(10, 8)).astype(np.float32))
    plc = ExpertPlacement.identity(8)
    got = topk_router_replicated(logits, 2, plc.replica_slots, plc.replica_count, 8)
    want = ref.ref_topk_router_replicated(logits, 2, plc.replica_slots, plc.replica_count, 8)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_)
    for g_, w_ in zip(topk_router(logits, 2), ref.ref_topk_router(logits, 2)):
        torch.testing.assert_close(g_, w_)
    q, k, v = (torch.from_numpy(a) for a in _slot_case(4, 2, 32, 4, 2, 16))
    lens = torch.tensor([0, 17], dtype=torch.int32)
    torch.testing.assert_close(flash_decode(q, k, v, lens), ref.ref_flash_decode(q, k, v, lens))
    assert len(KERNELS) == 5
    assert {fn.__name__: fn.launches for fn in KERNELS} == {fn.__name__: 0 for fn in KERNELS}


def test_no_silent_fallback_off_the_cpu():
    """A tensor that is not on the CPU is never served by the plain path: the
    wrappers accept only CUDA tensors there, and asking for the card where
    there is none raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card contract cannot be checked here")
    x = torch.empty((2, 8, 16), device="meta")
    w = torch.empty((2, 16, 24), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        moe_gemm(x, w)
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode_paged(torch.empty((2, 4, 16), device="meta"),
                           torch.empty((5, 16, 2, 16), device="meta"),
                           torch.empty((5, 16, 2, 16), device="meta"),
                           torch.empty((2, 2), dtype=torch.int32, device="meta"),
                           torch.empty((2,), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        topk_router_replicated(torch.empty((4, 8), device="meta"), 2,
                               torch.empty((8, 1), dtype=torch.int32, device="meta"),
                               torch.empty((8,), dtype=torch.int32, device="meta"), 8)
    with pytest.raises(ValueError, match="CUDA"):
        topk_router(torch.empty((4, 8), device="meta"), 2)
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode(torch.empty((2, 4, 16), device="meta"),
                     torch.empty((2, 32, 2, 16), device="meta"),
                     torch.empty((2, 32, 2, 16), device="meta"),
                     torch.empty((2,), dtype=torch.int32, device="meta"))
    with pytest.raises(RuntimeError, match="cuda"):
        devlib.resolve("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        devlib.resolve(None)                      # the default is the card


def test_library_hash_covers_every_shared_header(tmp_path, monkeypatch):
    """A changed shared header renames (so rebuilds) every library; a
    changed source renames only its own."""
    for src in _build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build._lib_path(n) for n in _build.SOURCES}
    hdr = tmp_path / "split_decode.cuh"
    hdr.write_text(hdr.read_text() + "\n// changed\n")
    after = {n: _build._lib_path(n) for n in _build.SOURCES}
    assert all(before[n] != after[n] for n in _build.SOURCES)
    (tmp_path / "extra.cuh").write_text("#pragma once\n")
    assert _build._lib_path("moe_gemm") != after["moe_gemm"]
    src = tmp_path / "moe_gemm.cu"
    src.write_text(src.read_text() + "\n")
    final = {n: _build._lib_path(n) for n in _build.SOURCES}
    assert final["flash_decode"] == _build._lib_path("flash_decode")
    assert final["moe_gemm"] != after["moe_gemm"]


def test_port_imports_neither_jax_nor_reference():
    """Importing every module of repro_torch (and chip_smoke.py) leaves jax,
    the reference package and ml_dtypes (which JAX registers with numpy) out
    of sys.modules; the expert level, the slot cache, both new kernels, the
    workloads and the cluster plane (dispatch, cluster, drills) are among
    the modules walked, and so are the simulator plane, the Mamba2 mixer,
    every config of the architecture registry and the training modules
    (a bf16 checkpoint saved and restored pulls in no ml_dtypes either),
    and the sharding layer and serving driver (a one-rank gloo mesh, its
    spec trees and a context step run without them)."""
    code = """
import importlib, pkgutil, sys
import repro_torch
import repro_torch.workloads, repro_torch.serving.cluster
import repro_torch.distributed.drill, repro_torch.core.dispatch
import repro_torch.sim, repro_torch.configs
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
sys.path.insert(0, sys.argv[1])
importlib.import_module("chip_smoke")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes"))
assert not bad, bad
need = {"repro_torch.core.placement", "repro_torch.core.affinity",
        "repro_torch.core.eplb", "repro_torch.core.gimbal",
        "repro_torch.serving.kvcache", "repro_torch.kernels.flash_decode",
        "repro_torch.kernels.topk_router", "repro_torch.workloads",
        "repro_torch.serving.cluster", "repro_torch.distributed.drill",
        "repro_torch.core.dispatch", "repro_torch.core.prefix_directory",
        "repro_torch.serving.metrics", "repro_torch.distributed.fault",
        "repro_torch.sim", "repro_torch.sim.costmodel", "repro_torch.sim.backend",
        "repro_torch.sim.simulator", "repro_torch.configs.gemma2_2b",
        "repro_torch.configs.qwen2_72b", "repro_torch.configs.granite_20b",
        "repro_torch.configs.granite_3_8b", "repro_torch.configs.internvl2_26b",
        "repro_torch.configs.deepseek_v2_236b", "repro_torch.configs.whisper_medium",
        "repro_torch.configs.llama4_maverick_400b_a17b",
        "repro_torch.configs.mamba2_370m", "repro_torch.configs.zamba2_1_2b",
        "repro_torch.models.mamba2", "repro_torch.training.optimizer",
        "repro_torch.training.checkpoint", "repro_torch.training.data",
        "repro_torch.launch.steps", "repro_torch.launch.train", "repro_torch.tree",
        "repro_torch.distributed.context", "repro_torch.distributed.sharding",
        "repro_torch.models.moe_sharded", "repro_torch.launch.mesh",
        "repro_torch.launch.serve"}
assert need <= set(sys.modules), need - set(sys.modules)
from repro_torch.configs import ASSIGNED_ARCHS, list_archs, get_config
assert len(ASSIGNED_ARCHS) == 10 and len(list_archs()) == 11
assert all(get_config(a).total_params() > 0 for a in list_archs())
from repro_torch.sim import simulate, SimEngine, CostModel, PROFILES
from repro_torch.core.gimbal import make_sim_expert_level
from repro_torch.serving.kvcache import SlotKVCache, BlockLedger, batch_axes, write_slot
from repro_torch.core.eplb import ExpertRebalancer, ClusterExpertLevel
from repro_torch.core.gimbal import make_rebalancer, make_cluster_expert_level
from repro_torch.kernels import flash_decode, topk_router, decode_attention, route
from repro_torch.workloads import burstgpt_trace, sharegpt_trace, suite_trace
from repro_torch.serving import Cluster, Engine, MetricsBus
from repro_torch.distributed import run_drill, HealthMonitor
from repro_torch.core import DispatchCore, PrefixDirectory, make_router, synthetic_stats
import tempfile, torch
from repro_torch.launch.train import train
from repro_torch.training.checkpoint import restore_checkpoint, save_checkpoint
with tempfile.TemporaryDirectory() as d:
    save_checkpoint(d, 1, {"w": torch.ones(3, dtype=torch.bfloat16)})
    assert restore_checkpoint(d, {"w": torch.zeros(3, dtype=torch.bfloat16)})[1]["w"].sum() == 3
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import make_ctx, make_decode_step
from repro_torch.distributed.sharding import param_specs, named
from repro_torch.launch.serve import build_cluster, serve
from repro_torch.configs import get_smoke_config
from repro_torch.models import model as M
from repro_torch.models.config import ShapeCell
ctx = make_ctx(make_mesh((1, 1), ("data", "model"), device="cpu"))
assert named(ctx.mesh, param_specs(get_config("qwen3-30b-a3b"), ctx))
cfg = get_smoke_config("qwen3-30b-a3b")
step = make_decode_step(cfg, ctx, ShapeCell("d", 8, 2, "decode"))[0]
nxt, _ = step(M.init_params(cfg, device="cpu"), M.init_cache(cfg, 2, 8, device="cpu"),
              {"tokens": torch.zeros((2, 1), dtype=torch.int32),
               "cache_pos": torch.zeros(2, dtype=torch.int32)})
assert nxt.shape == (2,)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes"))
assert not bad, bad
print("ok", len([m for m in sys.modules if m.startswith("repro_torch")]))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code, str(REPO)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
