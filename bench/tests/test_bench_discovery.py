"""A cell, a configuration, a traffic mix and a per-layer metric are picked
up from new files and entries alone, and every name in BENCHMARK.json has
its file."""
import json
import shutil

from bench import spec


def test_every_entry_has_its_files():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        cell = spec.find_cell(w["name"])
        assert cell.config["architecture"]
        spec.reference_module(cell.config)
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert callable(spec.metric_reader(m["name"]))
            assert m["moves"] in {e["name"] for e in cell.end_to_end}


def test_new_cell_config_traffic_and_metric_from_files_alone(tmp_path):
    root = tmp_path
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(spec.BENCH / sub, root / "bench" / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load_benchmark()
    src = spec.find_cell("qwen3-burstgpt-mmpp")
    (root / "bench" / "configs" / "new-model.json").write_text(
        json.dumps(dict(src.config, name="new-model")))
    mix = dict(src.traffic, arrival={"process": "poisson", "rps": 3.0})
    (root / "bench" / "traffic" / "new-mix.json").write_text(json.dumps(mix))
    (root / "bench" / "metrics" / "new_metric.py").write_text(
        "def read(run):\n    return 42.0 if run == 'x' else None\n")
    (root / "bench" / "metrics" / "silent.py").write_text("def read(run):\n    return None\n")
    bench["configs"].append({"name": "new-model", "source": "https://example.org",
                             "file": "bench/configs/new-model.json", "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "new-cell", "config": "new-model", "traffic": "new-mix",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "new_metric", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "backend",
                               "moves": "itl_mean_ms", "workloads": ["new-cell"]})
    bench["per_layer"].append({"name": "silent", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "backend", "moves": "setup_s"})
    next(m for m in bench["end_to_end"] if m["name"] == "itl_mean_ms")["workloads"].append("new-cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.find_cell("new-cell", root)
    assert cell.config["name"] == "new-model"
    assert cell.traffic["arrival"]["rps"] == 3.0
    assert [m["name"] for m in cell.per_layer] == ["new_metric", "silent"]
    assert {m["name"] for m in cell.end_to_end} == {"itl_mean_ms", "setup_s"}
    assert spec.read_metrics(cell, "x", root) == {"new_metric": {"value": 42.0, "unit": "ms"}}
    # the cells that were there do not see the new cell's metric
    old = spec.find_cell("qwen3-burstgpt-mmpp", root)
    assert "new_metric" not in {m["name"] for m in old.per_layer}
    assert "silent" in {m["name"] for m in old.per_layer}
    shutil.rmtree(root / "bench")


def test_a_width_the_port_does_not_have_is_refused():
    import copy

    import pytest

    from bench.serve import port_config
    for name in ("qwen3-burstgpt-mmpp", "dsv2-reasoning-closed"):
        config = spec.find_cell(name).config
        cfg = port_config(config)
        assert cfg.num_layers == config["num_hidden_layers"]
        assert config["num_hidden_layers"] < config["reduced"]["num_hidden_layers"]["published"]
        bad = copy.deepcopy(config)
        bad["moe_intermediate_size"] += 8
        with pytest.raises(ValueError, match="moe_d_ff"):
            port_config(bad)


def test_a_split_metric_reads_as_its_base():
    """``<base>.<part>`` with no file of its own is read by ``<base>.py``,
    and only a name with a dot falls back."""
    import pytest
    base = spec.metric_reader("decode_ms_per_step")
    split = spec.metric_reader("decode_ms_per_step.closed")
    assert split.__code__.co_code == base.__code__.co_code
    assert split.__module__ != base.__module__
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("no_such_metric")
