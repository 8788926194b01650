"""Nothing under bench/ imports JAX or the JAX package ``repro`` (top-level
names compared whole: ``repro_torch`` begins with ``repro``), the
references import nothing of ``repro_torch``, nothing reads the JAX
package's harness, and a run's process holds no such module."""
import ast
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_no_jax_and_no_program_in_the_references():
    files = list(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        names = set(_imports(f))
        assert not names & FORBIDDEN, (f, names & FORBIDDEN)
        if "reference" in f.parts:
            assert "repro_torch" not in names, f
    assert not any(name == "repro" for name in FORBIDDEN - {"repro"})


def test_nothing_reads_the_jax_harness():
    word = "bench" + "marks"
    for f in BENCH.rglob("*.py"):
        text = f.read_text()
        assert f"import {word}" not in text and f"{word}/" not in text, f


def test_a_run_process_loads_no_jax():
    root = BENCH.parent
    code = ("import sys; import bench.run as R; from bench import check, serve, spec, trace; "
            "import repro_torch.serving.engine, repro_torch.configs; "
            "print(R.forbidden_modules())")
    env = dict(os.environ, PYTHONPATH=f"{root / 'src'}{os.pathsep}{root}")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=root, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_checkout_of_the_benchmark_alone_fails_without_a_result(tmp_path):
    import shutil
    shutil.copytree(BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", "qwen3-burstgpt-mmpp",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=300,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
