"""Discovery: a cell of ``BENCHMARK.json`` and every file it needs, found by
name, so that a later change adds a cell, a configuration, a traffic mix or
a per-layer metric by adding files and entries, never by editing one.

  configuration  ``configs[].file`` (a JSON file under the benchmark)
  traffic mix    ``bench/traffic/<traffic>.json``
  metric reader  ``bench/metrics/<metric>.py`` with ``read(run) -> float | None``;
                 a name ``<base>.<part>`` without a file of its own reads as
                 ``<base>`` does (one quantity split by the end-to-end metric
                 it moves in each cell)
  reference      ``bench/reference/<architecture>.py`` (the configuration's
                 ``architecture`` key)
  layout         ``bench/layouts/<architecture>.py``: the architecture's leaves,
                 the port's tree of them, a layer's operations and the kernel
                 work the roofline readers need (``bench/layouts/__init__.py``)
"""
from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def find_cell(name: str, root: Path = ROOT, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json with its files read.
    A per-layer metric without ``workloads`` goes to every cell that
    reports the end-to-end metric it ``moves``."""
    root = Path(root)
    bench = bench or load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(cells)}")
    w = cells[name]
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / "bench" / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return Cell(name, int(w["chips"]), w["config"], config, w["traffic"], traffic, e2e,
                per_layer)


def _load_file(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """``read(run)`` of ``bench/metrics/<name>.py``, else of the file of the
    name's part before its first dot."""
    path = Path(root) / "bench" / "metrics" / f"{name}.py"
    if not path.exists():
        path = path.with_name(name.split(".")[0] + ".py")
    return _load_file(path, "bench_metric_" + name.replace(".", "_").replace("-", "_")).read


def reference_module(config: dict, root: Path = ROOT):
    """``bench/reference/<architecture>.py`` of a configuration."""
    arch = config["architecture"]
    return _load_file(Path(root) / "bench" / "reference" / f"{arch}.py",
                      "bench_reference_" + arch)


def layout_module(config: dict, root: Path = ROOT):
    """``bench/layouts/<architecture>.py`` of a configuration, loaded once."""
    return _layout(config["architecture"], str(root))


@functools.lru_cache(maxsize=None)
def _layout(arch: str, root: str):
    return _load_file(Path(root) / "bench" / "layouts" / f"{arch}.py", "bench_layout_" + arch)


def read_metrics(cell: Cell, run, root: Path = ROOT) -> Dict[str, dict]:
    """Every per-layer metric of the cell whose reader finds something to
    read, as ``{name: {"value", "unit"}}``; a reader that returns None is
    left out."""
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"], root)(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
