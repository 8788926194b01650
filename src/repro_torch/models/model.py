"""Language model of the port: init / prefill / slot and paged decode,
ported from ``repro.models.model`` for every family: MoE (qwen3;
deepseek-v2's dense prologue, shared experts and MLA; llama4's interleaved
top-1 MoE), dense (gemma2's local/global alternation and softcaps, qwen2's
QKV bias, granite's GQA and MQA), a VLM's language model (internvl2, whose
stub vision frontend's embeddings prefix the tokens at prefill),
whisper's encoder-decoder (stub frame embeddings in, cross-attention over
the encoder memory), the pure SSM (mamba2: a stack of Mamba2 blocks) and
the hybrid (zamba2: super-blocks of one shared attention block and
``shared_attn_every`` Mamba2 blocks, then the leftover Mamba2 blocks).

Parameters and caches keep the reference's trees: ``params["blocks"]``
holds every scanned layer's tensors with a leading axis, so a layer is
``a[l]`` of every leaf and relocating experts is a gather on the expert
axis; ``params["prologue"]`` / ``cache["prologue"]`` are lists of per-layer
trees; an interleaved stack groups ``{"moe": (n_super, ...), "dense":
(n_super, moe_every - 1, ...)}``; a hybrid holds one ``shared_attn`` tree,
reused at every call, its mamba blocks as (n_super, k, ...) and
``epi_blocks`` (n_epi, ...), and caches ``super_attn`` (n_super, ...),
``super_mamba`` (n_super, k, ...) and ``epi``.  A Python loop over layers
replaces ``lax.scan``, so each layer's local/global flag is a Python bool
and only its own attention branch runs (the reference's scan computes both
branches and selects).

``forward_train`` is the training forward (no cache).  With ``cfg.remat``
each stack unit runs under ``torch.utils.checkpoint`` (non-reentrant), as
the reference wraps its scan bodies in ``jax.checkpoint``: each layer of an
attention stack (the interleaved stack's layers one by one, where the
reference checkpoints a super-block), each Mamba2 layer and
shared-attention call of an SSM or hybrid stack, and each decoder layer of
whisper.  ``cfg.remat_policy`` picks what a unit keeps for the backward
pass: "none" nothing (everything is recomputed), "dots" the outputs of its
matrix products, anything else everything (selective-checkpoint contexts
in place of the reference's ``checkpoint_dots`` and
``everything_saveable``).

Under a shard context (``distributed/context.py``) the MoE layers take the
expert-parallel path and the slot decodes the sequence-sharded ones
(``models/blocks.py``, ``models/attention.py``).  ``ctx.paired_lg`` and
``ctx.unroll`` have no effect: the reference pairs (local, global) layers
to keep a runtime flag out of its scan, and the port's loop already gives
each layer its own static flag, so its stack is the paired stack.  Every
layer computes on its "model" blocks (the model axis of
``distributed/context.py``).  Where the reference's ``_seq_constraint``
pins the residual stream to the sequence over "model" (``seq_spec``: a
multi-token call whose sequence divides the axis, ``ctx.seq_parallel``),
the stack runs with ``ShardCtx.seq_blocks``: the embedding's output is
reduce-scattered to the rank's sequence block, the residual stays that
block between blocks, and the head gathers it back (whisper's encoder and
decoder loops too, each by its own length).
The embedding looks up the rank's vocab rows, the others masked to
0, and sums over "model" (where the vocab does not divide the axis it
looks up the rank's block of ``d`` and gathers it); the head computes the
logits on the rank's vocab block (where it does not divide, on the rank's
block of ``d``, summed) and returns them whole, or as the block
(``VocabBlock``, ``vocab_blocks=True``) for the vocab-parallel loss of
``launch/steps.py``.  Stored weights and caches (``distributed/sharding.py``'s
store) are gathered where they are used: a layer's in its layers
(``models/blocks.py``), the embedding, the final norm and whisper's
encoder norm and memory here.  Under batch blocks (``ShardCtx.batch_blocks``:
the steps of ``launch/steps.py`` given a stored batch) every activation is
this rank's rows of the global batch: the tokens, positions, a VLM's vision
prefix, whisper's frames and encoder memory, and the logits; a stored
cache opens to the rank's rows (``context.gather_rows``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import device as devlib
from repro_torch import tracing
from repro_torch.distributed.context import (Stored, block_of, check_cache, current_ctx,
                                             gather, gather_rows, gather_tree,
                                             reduce_from_model, scatter_seq, shard_ctx,
                                             whole_of, write_back)
from repro_torch.distributed.sharding import leaf_spec, model_block, model_dim, seq_spec
from repro_torch.models import blocks as B
from repro_torch.models import mamba2 as m2
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (embed_apply, enter, init_embed, init_rms_norm,
                                       residual_norm, rms_norm, softcap, unembed_apply)
from repro_torch.models.moe import ExpertPlacement
from repro_torch.tree import leaves


class VocabBlock(NamedTuple):
    """Logits on this rank's block of the vocabulary: ``local`` (B, S,
    V / tp) f32 holds the logits of tokens [start, start + V / tp)."""
    local: torch.Tensor
    start: int


def check_paged(cfg: ModelConfig) -> None:
    """The paged KV layout takes homogeneous GQA stacks only (the
    reference's ``PagedKVCache`` errors)."""
    if (cfg.attention_type != "gqa" or cfg.is_ssm or cfg.is_hybrid
            or cfg.is_encoder_decoder):
        raise ValueError("PagedKVCache supports homogeneous GQA stacks only")
    if cfg.is_moe and (cfg.first_k_dense != 0 or cfg.moe_every != 1):
        raise ValueError("PagedKVCache requires a homogeneous layer stack "
                         "(first_k_dense == 0, moe_every == 1)")


def _stack(trees: List[Any]):
    """Stack per-layer trees leaf by leaf, dropping each layer's leaf once it
    is stacked, so the copy never holds more than one leaf twice."""
    if isinstance(trees[0], dict):
        return {k: _stack([t.pop(k) for t in trees]) for k in list(trees[0])}
    out = torch.stack(trees)
    trees.clear()
    return out


def _layer(tree, l: int):
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    return tree[l]


def _n_prologue(cfg: ModelConfig) -> int:
    return cfg.first_k_dense if cfg.is_moe else 0


def _interleaved(cfg: ModelConfig) -> bool:
    return cfg.is_moe and cfg.moe_every > 1


def _hybrid_split(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_super, k, n_epi): super-blocks of one shared attention block and
    k mamba blocks, then n_epi mamba blocks."""
    k = cfg.shared_attn_every
    return cfg.num_layers // k, k, cfg.num_layers % k


# =============================================================================
# init
# =============================================================================

class _NoDraw:
    """Stands in for a generator on the meta device, where nothing is
    drawn: ``layers.normal`` gives an empty meta tensor of the shape."""

    def __init__(self, device: torch.device):
        self.device = device


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Seeded random parameters on ``device`` (the card by default), drawn
    from the same distributions as the reference's init and laid out in its
    tree (not the same numbers: bridge the reference's weights with
    ``models.convert``).  On ``device="meta"`` the tree holds shapes and
    dtypes only (``abstract_params``)."""
    dev = devlib.resolve(device, meta_ok=True)
    if dev.type == "meta":
        gen = _NoDraw(dev)
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    params: Dict[str, Any] = {
        "embed": init_embed(gen, cfg.vocab_size, cfg.d_model, cfg.adtype,
                            cfg.tie_embeddings),
        "final_norm": init_rms_norm(cfg.d_model, cfg.adtype, dev),
    }
    if cfg.is_encoder_decoder:
        params["enc_blocks"] = _stack([B.init_block(gen, cfg, False)
                                       for _ in range(cfg.num_encoder_layers)])
        params["enc_final_norm"] = init_rms_norm(cfg.d_model, cfg.adtype, dev)
        params["blocks"] = _stack([B.init_cross_block(gen, cfg)
                                   for _ in range(cfg.num_layers)])
        return params
    if cfg.is_hybrid:
        n_super, k, n_epi = _hybrid_split(cfg)
        params["shared_attn"] = B.init_block(gen, cfg, False)
        params["blocks"] = _stack([
            _stack([B.init_block(gen, cfg, False, "mamba") for _ in range(k)])
            for _ in range(n_super)])
        if n_epi:
            params["epi_blocks"] = _stack([B.init_block(gen, cfg, False, "mamba")
                                           for _ in range(n_epi)])
        return params
    if cfg.is_ssm:
        params["blocks"] = _stack([B.init_block(gen, cfg, False, "mamba")
                                   for _ in range(cfg.num_layers)])
        return params
    n_pro = _n_prologue(cfg)
    if n_pro:
        params["prologue"] = [B.init_block(gen, cfg, False) for _ in range(n_pro)]
    if _interleaved(cfg):
        me = cfg.moe_every
        n_super, rest = divmod(cfg.num_layers - n_pro, me)
        if rest:
            raise ValueError(f"{cfg.name}: {cfg.num_layers - n_pro} layers do not "
                             f"group evenly into super-blocks of {me}")
        moe_b, dense_b = [], []
        for _ in range(n_super):
            moe_b.append(B.init_block(gen, cfg, True))
            dense_b.append(_stack([B.init_block(gen, cfg, False) for _ in range(me - 1)]))
        params["blocks"] = {"moe": _stack(moe_b), "dense": _stack(dense_b)}
        return params
    params["blocks"] = _stack([B.init_block(gen, cfg, cfg.layer_is_moe(i))
                               for i in range(n_pro, cfg.num_layers)])
    return params


def abstract_params(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree on the meta device: every leaf's shape and dtype,
    nothing allocated (the reference's ``abstract_params``)."""
    return init_params(cfg, device="meta")


# =============================================================================
# caches
# =============================================================================

def _map_shapes(fn, tree):
    """Map ``fn`` over the shape tuples of a ``cache_shapes`` tree (dicts and
    lists are nodes, tuples are leaves)."""
    if isinstance(tree, dict):
        return {k: _map_shapes(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_shapes(fn, v) for v in tree]
    return fn(tree)


def cache_shapes(cfg: ModelConfig, batch: int, max_seq: int) -> Dict[str, Any]:
    """The shape of every leaf of ``init_cache``'s tree, allocating nothing:
    the same tree, with a shape tuple in place of each tensor."""
    if cfg.is_encoder_decoder:
        kv = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
        return {"layers": {"k": kv, "v": kv},
                "memory": (batch, cfg.encoder_len, cfg.d_model)}
    state = m2.cache_shapes(cfg, batch)
    if cfg.is_hybrid:
        n_super, k, n_epi = _hybrid_split(cfg)
        kv = (n_super, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
        shapes = {"super_attn": {"k": kv, "v": kv},
                  "super_mamba": _map_shapes(lambda s: (n_super, k) + s, state)}
        if n_epi:
            shapes["epi"] = _map_shapes(lambda s: (n_epi,) + s, state)
        return shapes
    if cfg.is_ssm:
        return {"layers": _map_shapes(lambda s: (cfg.num_layers,) + s, state)}
    if cfg.attention_type == "mla":
        per = {"ckv": (batch, max_seq, cfg.kv_lora_rank),
               "krope": (batch, max_seq, cfg.qk_rope_head_dim)}
    else:
        kv = (batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
        per = {"k": kv, "v": kv}
    n_pro = _n_prologue(cfg)
    n_scan = cfg.num_layers - n_pro
    if _interleaved(cfg):
        me = cfg.moe_every
        n_super = n_scan // me
        layers = {"moe": _map_shapes(lambda s: (n_super,) + s, per),
                  "dense": _map_shapes(lambda s: (n_super, me - 1) + s, per)}
    else:
        layers = _map_shapes(lambda s: (n_scan,) + s, per)
    shapes: Dict[str, Any] = {"layers": layers}
    if n_pro:
        shapes["prologue"] = [dict(per) for _ in range(n_pro)]
    return shapes


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device=None) -> Dict[str, Any]:
    """Zeroed cache in the reference's tree: {"layers": {"k": (L,B,S,Hkv,D),
    "v"}} for a homogeneous GQA stack (the slot layout's cache, and the
    prefill output the paged cache copies its pages from); MLA keeps
    {"ckv": (.., B,S,R), "krope": (.., B,S,Dr)}; a prologue adds a list of
    per-layer caches; whisper adds the encoder "memory" (B, enc_len, d); an
    SSM keeps {"layers": {"ssm": (L,B,H,P,N), "conv": (L,B,K-1,CC)}} and a
    hybrid {"super_attn", "super_mamba", "epi"} (see the module docstring).
    The SSM state is stored in ``dtype`` (``cfg.adtype`` by default); on
    ``device="meta"`` the tree holds shapes and dtypes only."""
    dev = devlib.resolve(device, meta_ok=True)
    dt = dtype or cfg.adtype
    return _map_shapes(lambda s: torch.zeros(s, dtype=dt, device=dev),
                       cache_shapes(cfg, batch, max_seq))


# =============================================================================
# forward passes
# =============================================================================

def _placement_stack(cfg: ModelConfig, placements, device) -> Optional[torch.Tensor]:
    """placements: None | (n_moe, S) int32 slot-map array, S = E + R, one
    row per MoE layer."""
    if placements is None or not cfg.is_moe:
        return None
    return torch.as_tensor(placements, dtype=torch.int32, device=device)


def _placement(cfg: ModelConfig, pstack, i: int) -> Optional[ExpertPlacement]:
    if pstack is None:
        return None
    return ExpertPlacement.from_slot_map(pstack[i], cfg.num_experts)


def _agg_aux(auxs: List[dict]) -> dict:
    """Sum the router losses over MoE layers; stack every other stat
    (n_moe, ...)."""
    out = {}
    if not auxs or not auxs[0]:
        return out
    for k in auxs[0]:
        v = torch.stack([a[k] for a in auxs])
        out[k] = v.sum() if k in ("load_balance_loss", "router_z_loss") else v
    return out


def _attn_layers(params, cfg: ModelConfig, cache) -> Iterator[Tuple[dict, Any, bool, bool]]:
    """The attention-family stack in execution order: (block params, its
    cache or None, local flag, is-MoE) for the dense prologue, then either
    the interleaved super-blocks (one MoE layer, then moe_every - 1 dense
    ones) or the homogeneous scanned stack."""
    n_pro = _n_prologue(cfg)
    for i in range(n_pro):
        yield (params["prologue"][i],
               cache["prologue"][i] if cache is not None else None, False, False)
    layers = cache["layers"] if cache is not None else None
    if _interleaved(cfg):
        blocks = params["blocks"]
        for s in range((cfg.num_layers - n_pro) // cfg.moe_every):
            yield (_layer(blocks["moe"], s),
                   _layer(layers["moe"], s) if layers is not None else None, False, True)
            dense = _layer(blocks["dense"], s)
            dense_c = _layer(layers["dense"], s) if layers is not None else None
            for j in range(cfg.moe_every - 1):
                yield (_layer(dense, j),
                       _layer(dense_c, j) if dense_c is not None else None, False, False)
        return
    for i in range(cfg.num_layers - n_pro):
        yield (_layer(params["blocks"], i),
               _layer(layers, i) if layers is not None else None,
               cfg.layer_is_local(n_pro + i), cfg.is_moe)


def _ssm_layers(params, cfg: ModelConfig, cache) -> Iterator[Tuple[dict, Any, bool]]:
    """An SSM or hybrid stack in execution order: (block params, its cache
    or None, is-attention).  A hybrid's super-blocks each call the one
    shared attention tree with that call's own KV cache, then their mamba
    blocks; the epilogue's mamba blocks follow."""
    def sub(tree, key, *idx):
        if tree is None:
            return None
        tree = tree[key]
        for i in idx:
            tree = _layer(tree, i)
        return tree

    if cfg.is_ssm:
        for l in range(cfg.num_layers):
            yield _layer(params["blocks"], l), sub(cache, "layers", l), False
        return
    n_super, k, n_epi = _hybrid_split(cfg)
    for s in range(n_super):
        yield params["shared_attn"], sub(cache, "super_attn", s), True
        for j in range(k):
            yield (_layer(_layer(params["blocks"], s), j),
                   sub(cache, "super_mamba", s, j), False)
    for j in range(n_epi):
        yield _layer(params["epi_blocks"], j), sub(cache, "epi", j), False


_MATMULS = frozenset(getattr(torch.ops.aten, name).default for name in (
    "mm", "bmm", "addmm", "baddbmm", "matmul", "linear",
    "_scaled_dot_product_efficient_attention", "_scaled_dot_product_flash_attention"))


def _save_dots(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the outputs of matrix products, recompute
    the rest (the reference's ``checkpoint_dots``)."""
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


_BUFFERS = frozenset(getattr(torch.ops.aten, name) for name in (
    "empty", "new_empty", "empty_like", "clone", "copy_"))


def _save_all(ctx, op, *args, **kwargs):
    """Any policy but "none" and "dots": keep everything (the reference's
    ``everything_saveable``) but the buffers a collective writes in place
    and the collectives themselves, which the recomputation runs again (a
    kept buffer would be handed back already written)."""
    if op.overloadpacket in _BUFFERS or op.namespace == "c10d":
        return CheckpointPolicy.PREFER_RECOMPUTE
    return CheckpointPolicy.MUST_SAVE


def _remat_policy(cfg: ModelConfig):
    """The selective-checkpoint context of ``cfg.remat_policy``, None for
    "none" (nothing kept, the plain checkpoint)."""
    if cfg.remat_policy == "none":
        return None
    policy = _save_dots if cfg.remat_policy == "dots" else _save_all
    return functools.partial(create_selective_checkpoint_contexts, policy)


def _unit(cfg: ModelConfig, fn, *args):
    """``fn(*args)``: one stack unit, recomputed in the backward pass as
    ``cfg.remat_policy`` says when ``cfg.remat`` is set.  The recomputation
    runs under the shard context of the forward: the context is
    thread-local, and autograd runs a CUDA backward on a thread of its own."""
    if not cfg.remat:
        return fn(*args)
    ctx = current_ctx()

    def unit(*a):
        with shard_ctx(ctx):
            return fn(*a)

    context_fn = _remat_policy(cfg)
    if context_fn is None:
        return checkpoint(unit, *args, use_reentrant=False)
    return checkpoint(unit, *args, use_reentrant=False, context_fn=context_fn)


def _run_stack(params, cfg: ModelConfig, x, cache, placements, stats: bool, block):
    """Run ``block(p, x, c, local, is_moe, placement, stats)`` over the
    stack; the placement stack and the stats are indexed by MoE layer.
    Returns (x, aux)."""
    pstack = _placement_stack(cfg, placements, x.device)
    auxs, n_moe = [], 0
    for p, c, local, is_moe in _attn_layers(params, cfg, cache):
        with tracing.span("layer"):
            plc = None
            if is_moe:
                with tracing.span("layer.placement"):
                    plc = _placement(cfg, pstack, n_moe)
            x, _, aux = _unit(cfg, block, p, x, c, local, is_moe, plc, stats and is_moe)
        if is_moe:
            auxs.append(aux)
            n_moe += 1
    return x, _agg_aux(auxs)


def _vocab_weight(params, cfg: ModelConfig, name: str):
    """(the embedding or unembedding as the rank computes on it, the dim
    its block cuts over "model" or None) under the active context."""
    ctx = current_ctx()
    w = params["embed"][name]
    dim = model_dim(leaf_spec(w, ("embed", name), cfg, ctx), ctx)
    return (gather(w) if dim is None else model_block(w, dim, ctx)), dim


def _head(params, cfg: ModelConfig, x, vocab_blocks: bool = False):
    """The final norm and the unembedding: logits (B, S, V) f32, whole
    over "model"; under a context with ``vocab_blocks`` and a vocab that
    divides the model axis, the rank's block (``VocabBlock``)."""
    ctx = current_ctx()
    name = "embedding" if cfg.tie_embeddings else "unembedding"
    if ctx is None:
        x = rms_norm(x, gather(params["final_norm"]["scale"]), cfg.norm_eps)
        return unembed_apply({"unembedding": gather(params["embed"][name])}, x,
                             cfg.final_logit_softcap)
    x = residual_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    seq = ctx.seq_blocks
    w, dim = _vocab_weight(params, cfg, name)
    if dim == 0:                                         # the rank's vocab rows
        local = unembed_apply({"unembedding": w}, enter(x, ctx, seq), cfg.final_logit_softcap)
        if vocab_blocks:
            return VocabBlock(local, ctx.mesh.axis_index(ctx.model_axis) * w.shape[0])
        return whole_of(local, ctx, 2)
    x = whole_of(x, ctx, 1) if seq else x
    if dim is None:
        return unembed_apply({"unembedding": w}, x, cfg.final_logit_softcap)
    # the rank's block of d, the partial logits summed over "model"
    part = torch.einsum("...d,vd->...v", block_of(x, ctx, 2), w).float()
    return softcap(reduce_from_model(part, ctx), cfg.final_logit_softcap)


def _embed(params, cfg: ModelConfig, tokens, seq: bool = False):
    """The token embeddings, under a context in the residual layout (the
    rank's sequence block when ``seq``)."""
    ctx = current_ctx()
    if ctx is None:
        return embed_apply(gather_tree(params["embed"]), tokens)
    w, dim = _vocab_weight(params, cfg, "embedding")
    if dim == 0:                                         # the rank's vocab rows
        rows = w.shape[0]
        ids = tokens.long() - ctx.mesh.axis_index(ctx.model_axis) * rows
        mine = (ids >= 0) & (ids < rows)
        e = w[ids.clamp(0, rows - 1)] * mine[..., None].to(w.dtype)
        return scatter_seq(e, ctx, 1) if seq else reduce_from_model(e, ctx)
    e = w[tokens]
    if dim is not None:                                  # the rank's block of d
        e = whole_of(e, ctx, 2)
    return block_of(e, ctx, 1) if seq else e


def _seq_ctx(s: int):
    """The active context with ``seq_blocks`` set where the reference's
    ``_seq_constraint`` pins a residual stream of ``s`` positions
    (``sharding.seq_spec``); None without a context."""
    ctx = current_ctx()
    if ctx is None:
        return None
    return dataclasses.replace(ctx, seq_blocks=seq_spec(ctx, (1, s, 1)) is not None)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


def _forward_encdec(params, cfg: ModelConfig, tokens, frames, cache, cache_pos,
                    decode: bool, vocab_blocks: bool = False):
    """whisper: the encoder over the stub frame embeddings (prefill), then
    the decoder with cross-attention over its memory.  Decode reads the
    memory from the cache; prefill with a cache stores it there.  Under a
    context each loop's residual is the rank's sequence block where
    ``seq_spec`` splits it; the memory is whole over "model"."""
    if decode:
        memory = gather_rows(cache["memory"])
    else:
        with shard_ctx(_seq_ctx(frames.shape[1])):
            memory = _encode(params, cfg, frames)
    with shard_ctx(_seq_ctx(tokens.shape[1])):
        ctx = current_ctx()
        x = _embed(params, cfg, tokens, ctx is not None and ctx.seq_blocks)
        b, s = tokens.shape
        positions = None if decode else _positions(b, s, x.device)
        layers = cache["layers"] if cache is not None else None
        for l in range(cfg.num_layers):
            p = _layer(params["blocks"], l)
            c = _layer(layers, l) if layers is not None else None
            if decode:
                x, _ = B.cross_block_decode(p, cfg, x, c, cache_pos, memory)
            else:
                x, _ = _unit(cfg, B.cross_block_full, p, cfg, x, positions, memory, c)
        logits = _head(params, cfg, x, vocab_blocks)
    if cache is not None and not decode:
        if isinstance(cache["memory"], Stored):
            write_back(cache["memory"], memory)
        else:
            cache["memory"] = memory
    return logits, cache, {}


def _encode(params, cfg: ModelConfig, frames) -> torch.Tensor:
    """whisper's encoder: its memory (B, enc_len, d), whole over "model"."""
    ctx = current_ctx()
    seq = ctx is not None and ctx.seq_blocks
    x = frames.to(cfg.adtype)
    x = block_of(x, ctx, 1) if seq else x
    for i in range(cfg.num_encoder_layers):
        x = B.encoder_block_full(_layer(params["enc_blocks"], i), cfg, x)
    x = whole_of(x, ctx, 1) if seq else x
    return rms_norm(x, gather(params["enc_final_norm"]["scale"]), cfg.norm_eps)


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, *, cache=None,
            vision_embeds: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None, placements=None,
            dispatch_mode: str = "dense", stats: bool = False,
            vocab_blocks: bool = False):
    """Full-sequence forward (train-forward with cache=None, prefill with a
    cache, which is written in place).  For a VLM, ``vision_embeds``
    (B, P, d) precede the token embeddings, cast to their dtype, and the
    positions, logits and cache cover the P + S positions; whisper takes
    ``frames`` (B, enc_len, d).  Returns (logits (B,P+S,V) f32, cache, aux);
    ``vocab_blocks`` asks for the rank's vocab block under a context
    (``_head``)."""
    _check_caches(cache)
    if cfg.is_encoder_decoder:
        return _forward_encdec(params, cfg, tokens, frames, cache, None, False, vocab_blocks)
    vlm = cfg.family == "vlm" and vision_embeds is not None
    s = tokens.shape[1] + (vision_embeds.shape[1] if vlm else 0)
    with shard_ctx(_seq_ctx(s)):
        return _forward(params, cfg, tokens, cache, vision_embeds if vlm else None,
                        placements, dispatch_mode, stats, vocab_blocks)


def _check_caches(cache) -> None:
    """Under batch blocks refuse a whole cache before any collective runs
    (``context.check_cache``)."""
    if cache is not None:
        for leaf in leaves(cache):
            check_cache(leaf)


def _forward(params, cfg: ModelConfig, tokens, cache, vision_embeds, placements,
             dispatch_mode: str, stats: bool, vocab_blocks: bool):
    ctx = current_ctx()
    seq = ctx is not None and ctx.seq_blocks
    if vision_embeds is None:
        x = _embed(params, cfg, tokens, seq)
    else:
        x = torch.cat([vision_embeds.to(cfg.adtype), _embed(params, cfg, tokens)], dim=1)
        x = block_of(x, ctx, 1) if seq else x
    b, s = x.shape[0], tokens.shape[1] + (0 if vision_embeds is None
                                          else vision_embeds.shape[1])
    positions = _positions(b, s, x.device)
    if cfg.is_ssm or cfg.is_hybrid:
        for p, c, is_attn in _ssm_layers(params, cfg, cache):
            if is_attn:
                x, _, _ = _unit(cfg, B.attn_block_full, p, cfg, x, positions, False, c,
                                False, None, "dense", False)
            else:
                x, _ = _unit(cfg, B.mamba_block_full, p, cfg, x, c)
        return _head(params, cfg, x, vocab_blocks), cache, {}

    def block(p, x, c, local, is_moe, plc, st):
        return B.attn_block_full(p, cfg, x, positions, local, c, is_moe, plc,
                                 dispatch_mode, st)

    x, aux = _run_stack(params, cfg, x, cache, placements, stats, block)
    return _head(params, cfg, x, vocab_blocks), cache, aux


def forward_train(params, cfg: ModelConfig, tokens, **kw):
    """The training forward: ``forward`` with no cache.  Returns (logits,
    aux)."""
    logits, _, aux = forward(params, cfg, tokens, cache=None, **kw)
    return logits, aux


def prefill(params, cfg: ModelConfig, tokens, cache, **kw):
    return forward(params, cfg, tokens, cache=cache, **kw)


def decode_step(params, cfg: ModelConfig, token, cache, cache_pos, *,
                placements=None, dispatch_mode: str = "dense", stats: bool = False,
                mla_absorb: bool = False):
    """One decode step against the slot cache (serving/kvcache.SlotKVCache).

    token: (B, 1) int; cache: ``init_cache``'s tree, updated IN PLACE;
    cache_pos: (B,) next write position per row; ``mla_absorb`` picks MLA's
    latent-space decode.  Returns (logits (B,V), cache, aux)."""
    _check_caches(cache)
    if cfg.is_encoder_decoder:
        logits, cache, aux = _forward_encdec(params, cfg, token, None, cache,
                                             cache_pos, True)
        return logits[:, -1], cache, aux
    x = _embed(params, cfg, token)
    if cfg.is_ssm or cfg.is_hybrid:
        for p, c, is_attn in _ssm_layers(params, cfg, cache):
            if is_attn:
                x, _, _ = B.attn_block_decode(p, cfg, x, c, cache_pos, False, False, None,
                                              "dense", False)
            else:
                x, _ = B.mamba_block_decode(p, cfg, x, c)
        return _head(params, cfg, x)[:, -1], cache, {}

    def block(p, x, c, local, is_moe, plc, st):
        return B.attn_block_decode(p, cfg, x, c, cache_pos, local, is_moe, plc,
                                   dispatch_mode, st, mla_absorb)

    x, aux = _run_stack(params, cfg, x, cache, placements, stats, block)
    return _head(params, cfg, x)[:, -1], cache, aux


def decode_step_paged(params, cfg: ModelConfig, token, pages, block_tables,
                      lengths, *, placements=None, dispatch_mode: str = "dense",
                      stats: bool = False, use_kernel: bool = False):
    """One decode step against a paged KV pool (serving/kvcache.PagedKVCache;
    homogeneous GQA stacks only, as ``check_paged`` enforces).

    token: (B, 1) int; pages: {"k": (L,P,BS,Hkv,D), "v": ..., optional
    "k_scale"/"v_scale": (L,P)}, updated IN PLACE; block_tables: (B, NB)
    int32; lengths: (B,) tokens resident per row.  Returns (logits (B,V),
    pages, aux)."""
    check_paged(cfg)
    x = _embed(params, cfg, token)

    def block(p, x, c, local, is_moe, plc, st):
        return B.attn_block_decode_paged(p, cfg, x, c, block_tables, lengths, local,
                                         is_moe, plc, dispatch_mode, st, use_kernel)

    x, aux = _run_stack(params, cfg, x, {"layers": pages}, placements, stats, block)
    return _head(params, cfg, x)[:, -1], pages, aux
