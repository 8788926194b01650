"""A cell of the benchmark cut to widths a CPU test holds: the same files
and code path, the configuration's widths and the traffic's lengths made
small, float32 weights."""
from __future__ import annotations

import copy

from bench import spec
from bench.serve import WIDTHS

QWEN3 = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
             intermediate_size=128, num_experts=8, num_experts_per_tok=2,
             moe_intermediate_size=32, vocab_size=128, num_hidden_layers=2)
DSV2 = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=4, intermediate_size=128,
            q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16, n_routed_experts=8, n_shared_experts=2, num_experts_per_tok=2,
            moe_intermediate_size=32, vocab_size=128, num_hidden_layers=3)
SIZES = {"qwen3_moe": QWEN3, "deepseek_v2": DSV2}


def tiny_cell(name: str, dtype: str = "float32", max_seq: int = 256, max_slots: int = 4,
              out_max: int = 12, rps: float = 40.0):
    """(cell, port config) of ``name`` at test widths."""
    from repro_torch.configs import get_config
    cell = copy.deepcopy(spec.find_cell(name))
    c = cell.config
    c.update(SIZES[c["architecture"]])
    c["torch_dtype"] = dtype
    c["engine"].update(max_seq=max_seq, max_slots=max_slots, prefill_budget=256)
    fields = {WIDTHS[k]: c[k] for k in WIDTHS if k in c and k not in ("torch_dtype",)}
    fields.update(d_ff=c["intermediate_size"], num_layers=c["num_hidden_layers"], dtype=dtype)
    port_cfg = get_config(c["port_arch"]).replace(**fields)
    t = cell.traffic
    t["output"].update(min=2, max=out_max)
    if t["loop"] == "open":
        t["arrival"]["rps"] = rps
    t["warmup_s"] = 0.2
    return cell, port_cfg
