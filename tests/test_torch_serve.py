"""The port's serving driver (``repro_torch.launch.serve``) against the
reference's (``repro.launch.serve``) on the CPU, on the same weights: each
reference engine i draws ``init_params(jax.random.key(i))``, and the port's
``init_params`` is patched to return those weights, bridged through
``models/convert.py``.  Both drive the qwen3-30b-a3b smoke config with the
reference's defaults ("gimbal", 2 engines, ``--n 40``, the 0.05 s logical
clock, a ``HealthMonitor``) on both scaled traces (BurstGPT, the default,
and ShareGPT), with and without ``--fail-engine 1``.  The printed lines, the re-route counts in
them, the dispatcher's assignment and lifecycle logs, every engine's event
log and the finished requests must be identical.

The reference's second engine reuses the first's compiled decode and
prefill functions (they take the weights as arguments), as in
tests/test_torch_cluster.py.
"""
import contextlib
import io
import sys

import jax
import numpy as np
import pytest

import repro.launch.serve as JSV
from repro.models import model as JM
from repro_torch.launch import serve as TSV
from repro_torch.models.convert import params_from_numpy

N = 40          # serve's default --n


def _share_jits(cluster):
    first = None
    for eid in sorted(cluster.engines):
        b = cluster.engines[eid].backend
        if first is None:
            first = b
            continue
        b._jit_decode = first._jit_decode
        b._jit_decode_paged = first._jit_decode_paged
        b._prefill_for_bucket = first._prefill_for_bucket
    return cluster


def _reference(monkeypatch, trace: str, fail: int):
    built = []

    def build(*a, **kw):
        built.append(_share_jits(real(*a, **kw)))
        return built[-1]

    real = JSV.build_cluster
    monkeypatch.setattr(JSV, "build_cluster", build)
    monkeypatch.setattr(sys, "argv", ["serve", "--n", str(N), "--trace", trace,
                                      "--fail-engine", str(fail)])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        JSV.main()
    return built[0], [line for line in buf.getvalue().splitlines() if line.startswith("[serve]")]


def _port(monkeypatch, trace: str, fail: int):
    def weights(cfg, seed=0, device=None):
        tree = jax.tree.map(np.asarray, JM.init_params(jax.random.key(seed), _jax_cfg()))
        return params_from_numpy(tree, device)

    monkeypatch.setattr(TSV.M, "init_params", weights)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cluster, lines = TSV.serve(n=N, trace=trace, fail_engine=fail, device="cpu")
    assert buf.getvalue().splitlines() == lines
    return cluster, lines


def _jax_cfg():
    return JSV.get_smoke_config("qwen3-30b-a3b")


def _finished(cl):
    return sorted((r.req_id, r.engine_id, r.generated, r.first_token_time, r.finish_time)
                  for r in cl.finished)


@pytest.mark.parametrize("fail", [-1, 1])
@pytest.mark.parametrize("trace", ["burstgpt", "sharegpt"])
def test_serve_matches_reference(monkeypatch, trace, fail):
    jcl, jlines = _reference(monkeypatch, trace, fail)
    tcl, tlines = _port(monkeypatch, trace, fail)
    assert tlines == jlines
    assert tcl.dispatch.assignment_log() == jcl.dispatch.assignment_log()
    assert tcl.dispatch.lifecycle_log() == jcl.dispatch.lifecycle_log()
    assert sorted(tcl.engines) == sorted(jcl.engines)
    for eid in jcl.engines:
        assert tcl.engines[eid].core.event_log() == jcl.engines[eid].core.event_log(), eid
    assert _finished(tcl) == _finished(jcl)
    assert len(tcl.finished) == N
    if fail >= 0:
        moved = [line for line in tlines if line.startswith("[serve] re-routed")]
        assert len(moved) == 1 and int(moved[0].split()[2]) > 0
        assert not tcl.engines[fail].healthy
    else:
        assert not any("re-rout" in line for line in tlines)
