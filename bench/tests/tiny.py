"""A cell of the benchmark cut to widths a CPU test holds: the same files
and code path, the configuration's widths and the traffic's lengths made
small (the layout's ``TINY``), float32 weights."""
from __future__ import annotations

import copy

from bench import spec
from bench.serve import widths


def tiny_cell(name: str, dtype: str = "float32", max_seq: int = 256, max_slots: int = 4,
              out_max: int = 12, rps: float = 40.0):
    """(cell, port config) of ``name`` at test widths."""
    from repro_torch.configs import get_config
    cell = copy.deepcopy(spec.find_cell(name))
    c = cell.config
    c.update(spec.layout_module(c).TINY)
    c["torch_dtype"] = dtype
    c["engine"].update(max_seq=max_seq, max_slots=max_slots, prefill_budget=256)
    fields = {f: c[k] for k, f in widths(c).items() if k in c and k != "torch_dtype"}
    fields.update(num_layers=c["num_hidden_layers"], dtype=dtype)
    port_cfg = get_config(c["port_arch"]).replace(**fields)
    t = cell.traffic
    t["output"].update(min=2, max=out_max)
    if t["loop"] == "open":
        t["arrival"]["rps"] = rps
    t["warmup_s"] = 0.2
    return cell, port_cfg
