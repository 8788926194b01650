"""Flash-decode: one-token GQA attention over a paged KV pool or a
contiguous slot cache.

Replaces the TPU kernels ``src/repro/kernels/flash_decode.py::
flash_decode_paged`` (``_paged_kernel``) and ``flash_decode`` (``_kernel``).
The CUDA kernels are ``csrc/flash_decode_paged.cu`` and
``csrc/flash_decode.cu``; each says what bounds it on the H100 (the bytes of
the resident K/V) and how its design answers that: one block per (row, KV
head) holding all G query heads, so each K/V tile is read once per group;
only B * Hkv blocks are in flight.

On a CPU tensor each wrapper computes its plain version
(``ref.ref_flash_decode_paged`` / ``ref.ref_flash_decode``); on a CUDA
tensor it launches the kernel or raises.  Each wrapper's ``launches``
counts its kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_flash_decode, ref_flash_decode_paged

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_SMEM = 48 * 1024     # default dynamic shared memory limit of one block


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_decode_paged_launch.argtypes = [p] * 8 + [i] * 6 + [f, f, i, i, p]
    lib.flash_decode_paged_launch.restype = i
    lib.flash_decode_paged_smem_bytes.argtypes = [i, i, i]
    lib.flash_decode_paged_smem_bytes.restype = i


def _bind_slot(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_decode_launch.argtypes = [p] * 5 + [i] * 5 + [f, f, i, p]
    lib.flash_decode_launch.restype = i
    lib.flash_decode_smem_bytes.argtypes = [i, i]
    lib.flash_decode_smem_bytes.restype = i


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
    lengths: (B,) int32 valid tokens per row.  Returns (B, Hq, D) in q's
    dtype; a row with length 0 is exactly zero."""
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
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _build.load("flash_decode_paged", _bind)
    g = hq // hkv
    if lib.flash_decode_paged_smem_bytes(bs, d, g) > _MAX_SMEM:
        raise ValueError(f"flash_decode_paged: block size {bs}, head dim {d} and "
                         f"group {g} need more than {_MAX_SMEM} B of shared memory")
    rc = lib.flash_decode_paged_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, nb, bs, hkv, d, g, d ** -0.5, float(softcap),
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pages.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "flash_decode_paged")
    flash_decode_paged.launches += 1
    return out


flash_decode_paged.launches = 0


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor, *, softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Hq, D); k, v: (B, S, Hkv, D) slot cache in q's dtype (f32 or
    bf16); lengths: (B,) int32 valid tokens per row.  Returns (B, Hq, D) in
    q's dtype; positions >= length are masked and a row with length 0 is
    exactly zero."""
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
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _build.load("flash_decode", _bind_slot)
    g = hq // hkv
    if lib.flash_decode_smem_bytes(d, g) > _MAX_SMEM:
        raise ValueError(f"flash_decode: head dim {d} and group {g} need more "
                         f"than {_MAX_SMEM} B of shared memory")
    rc = lib.flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, s, hkv, d, g, d ** -0.5, float(softcap), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
