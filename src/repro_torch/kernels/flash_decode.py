"""Flash-decode: one-token GQA attention over a paged KV pool or a
contiguous slot cache.

Replaces the TPU kernels ``src/repro/kernels/flash_decode.py::
flash_decode_paged`` (``_paged_kernel``) and ``flash_decode`` (``_kernel``).
The CUDA kernels are ``csrc/flash_decode_paged.cu`` and
``csrc/flash_decode.cu``.  What bounds both on the H100 is the bytes of the
resident K/V, and a decode batch has too few (row, KV head) pairs to put
those bytes in flight on every SM, so both share one design
(``csrc/split_decode.cuh``): each row's sequence is split over blocks of
32-position chunks (``split_plan``, from shapes alone), each block holds
all G query heads of its KV head so that each K/V byte is read once, and a
second launch merges the blocks' f32 partials.  The two kernels differ only
in how a position finds its K/V row (a contiguous slot, or its page through
the block table) and in the int8 page scales.

On a CPU tensor each wrapper computes its plain version
(``ref.ref_flash_decode_paged`` / ``ref.ref_flash_decode``); on a CUDA
tensor it launches the kernel or raises.  Each wrapper's ``launches``
counts its calls that launched (one per call, though a call is two
launches: split and merge).
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_flash_decode, ref_flash_decode_paged

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_DYN_SMEM = 232_448   # dynamic shared memory one H100 block may use, opted in
CHUNK = 32                # positions per chunk of the split pass
BLOCKS_PER_SM = 8         # split-pass blocks the plan aims for on each SM


def _bind_common(lib: ctypes.CDLL, name: str) -> None:
    """The smem and chunk entries every split-decode library exports; the
    library must chunk as the plan does."""
    i = ctypes.c_int
    getattr(lib, f"{name}_smem_bytes").argtypes = [i, i, i]
    getattr(lib, f"{name}_smem_bytes").restype = i
    chunk = getattr(lib, f"{name}_chunk")
    chunk.restype = i
    if chunk() != CHUNK:
        raise RuntimeError(f"{name}: csrc/split_decode.cuh chunks {chunk()} "
                           f"positions, the plan {CHUNK}")


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_decode_paged_launch.argtypes = [p] * 9 + [i] * 8 + [f, f, i, i, p]
    lib.flash_decode_paged_launch.restype = i
    _bind_common(lib, "flash_decode_paged")


def _bind_slot(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_decode_launch.argtypes = [p] * 6 + [i] * 7 + [f, f, i, p]
    lib.flash_decode_launch.restype = i
    _bind_common(lib, "flash_decode")


def _check(name: str, t: torch.Tensor, dtypes, ndim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}; kernel takes {dtypes}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-d tensor, "
                         f"got shape {tuple(t.shape)}")


def flash_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, block_tables: torch.Tensor,
                       lengths: torch.Tensor, *,
                       k_scale: Optional[torch.Tensor] = None,
                       v_scale: Optional[torch.Tensor] = None,
                       softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Hq, D); k_pages, v_pages: (P, BS, Hkv, D) page pool in q's
    dtype, or int8 with per-page f32 scales (P,); block_tables: (B, NB) int32;
    lengths: (B,) int32 valid tokens per row, clamped to NB * BS.  Returns
    (B, Hq, D) in q's dtype; a row with length 0 is exactly zero.  One call
    is two launches (split, merge), counted once; the plan reads shapes
    only, never ``lengths``."""
    if q.device.type == "cpu":
        return ref_flash_decode_paged(q, k_pages, v_pages, block_tables, lengths,
                                      softcap=softcap, k_scale=k_scale,
                                      v_scale=v_scale)
    b, hq, d = q.shape
    _, bs, hkv, _ = k_pages.shape
    nb = block_tables.shape[1]
    _check("q", q, (torch.float32, torch.bfloat16), 3)
    _check("k_pages", k_pages, (q.dtype, torch.int8), 4)
    _check("v_pages", v_pages, (k_pages.dtype,), 4)
    _check("block_tables", block_tables, (torch.int32,), 2)
    _check("lengths", lengths, (torch.int32,), 1)
    if (v_pages.shape != k_pages.shape or k_pages.shape[3] != d
            or hq % hkv != 0 or block_tables.shape[0] != b or lengths.shape[0] != b):
        raise ValueError("flash_decode_paged: inconsistent shapes "
                         f"q={tuple(q.shape)} pages={tuple(k_pages.shape)} "
                         f"tables={tuple(block_tables.shape)} lengths={tuple(lengths.shape)}")
    quantized = k_pages.dtype == torch.int8
    if quantized != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("int8 pages need k_scale and v_scale; other pages take none")
    if quantized:
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            _check(name, s, (torch.float32,), 1)
            if s.shape[0] != k_pages.shape[0]:
                raise ValueError(f"{name} must have one scale per page")
    item = k_pages.element_size()
    plan = split_plan(b, nb * bs, hq, hkv, d, item, _num_sms(q.device))
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("flash_decode_paged: k_pages and v_pages must start on a "
                         "16-byte boundary")
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _build.load("flash_decode_paged", _bind)
    g = hq // hkv
    if lib.flash_decode_paged_smem_bytes(d, g, item) > _MAX_DYN_SMEM:
        raise ValueError(f"flash_decode_paged: head dim {d} and group {g} need more "
                         f"than {_MAX_DYN_SMEM} B of shared memory")
    part = torch.empty(plan.scratch_floats, dtype=torch.float32, device=q.device)
    rc = lib.flash_decode_paged_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        block_tables.data_ptr(), lengths.data_ptr(), part.data_ptr(), out.data_ptr(),
        b, nb, bs, hkv, d, g, plan.n_split, plan.chunks_per_split, d ** -0.5,
        float(softcap), _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pages.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "flash_decode_paged")
    flash_decode_paged.launches += 1
    return out


flash_decode_paged.launches = 0


@dataclass(frozen=True)
class SplitPlan:
    """How one flash-decode call (slot or paged) is cut: ``n_split`` spans of
    ``chunks_per_split`` chunks of ``CHUNK`` positions per (row, KV head),
    and the f32 scratch of B * Hq * n_split * (D + 2) floats (acc, m, l)."""
    n_split: int
    chunks_per_split: int
    scratch_floats: int

    @property
    def span(self) -> int:
        return self.chunks_per_split * CHUNK


def split_plan(b: int, s: int, hq: int, hkv: int, d: int, itemsize: int,
               num_sms: int = 132) -> SplitPlan:
    """Cut each row's sequence into enough spans that the split pass has
    about ``BLOCKS_PER_SM`` blocks per SM (B * Hkv * n_split), one chunk per
    span where that suffices.  Raises on a head dim the kernel does not
    take: K and V rows are copied in 16-byte vectors."""
    if d < 1 or (d * itemsize) % 16:
        raise ValueError(f"flash_decode: head dim {d} must be a whole number of "
                         f"16-byte vectors of {itemsize}-byte elements")
    n_chunks = max(-(-s // CHUNK), 1)
    want = -(-BLOCKS_PER_SM * num_sms // max(b * hkv, 1))
    cps = -(-n_chunks // min(n_chunks, want))
    n_split = -(-n_chunks // cps)
    return SplitPlan(n_split, cps, b * hq * n_split * (d + 2))


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor, *, softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Hq, D); k, v: (B, S, Hkv, D) slot cache in q's dtype (f32 or
    bf16); lengths: (B,) int32 valid tokens per row.  Returns (B, Hq, D) in
    q's dtype; positions >= length are masked and a row with length 0 is
    exactly zero.  One call is two launches (split, merge), counted once."""
    if q.device.type == "cpu":
        return ref_flash_decode(q, k, v, lengths, softcap)
    _check("q", q, (torch.float32, torch.bfloat16), 3)
    _check("k", k, (q.dtype,), 4)
    _check("v", v, (q.dtype,), 4)
    _check("lengths", lengths, (torch.int32,), 1)
    b, hq, d = q.shape
    _, s, hkv, _ = k.shape
    if (v.shape != k.shape or k.shape[0] != b or k.shape[3] != d
            or hq % hkv != 0 or lengths.shape[0] != b):
        raise ValueError("flash_decode: inconsistent shapes "
                         f"q={tuple(q.shape)} k={tuple(k.shape)} v={tuple(v.shape)} "
                         f"lengths={tuple(lengths.shape)}")
    plan = split_plan(b, s, hq, hkv, d, q.element_size(), _num_sms(q.device))
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_decode: k and v must start on a 16-byte boundary")
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _build.load("flash_decode", _bind_slot)
    g = hq // hkv
    if lib.flash_decode_smem_bytes(d, g, q.element_size()) > _MAX_DYN_SMEM:
        raise ValueError(f"flash_decode: head dim {d} and group {g} need more "
                         f"than {_MAX_DYN_SMEM} B of shared memory")
    part = torch.empty(plan.scratch_floats, dtype=torch.float32, device=q.device)
    rc = lib.flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), part.data_ptr(),
        out.data_ptr(), b, s, hkv, d, g, plan.n_split, plan.chunks_per_split,
        d ** -0.5, float(softcap), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


@functools.lru_cache(maxsize=None)
def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
