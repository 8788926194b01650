"""The yardstick: the work counters against hand counts at smoke sizes,
and the trace reduction on a synthetic timeline."""
import pytest

from bench import trace
from bench.roofline import flash_decode_paged, model_flops, moe_gemm, peaks
from bench import spec


def test_peaks_and_least_seconds():
    assert peaks.least_seconds(3.35e12, 0) == 1.0
    assert peaks.least_seconds(0, 989e12) == 1.0
    assert peaks.least_seconds(3.35e9, 989e9 * 2) == 2e-3


def test_moe_gemm_counts_reached_experts_once():
    # 3 tokens x top-2 = 6 selections reaching 4 experts of width d=64, f=32
    nbytes, flops = moe_gemm.launch_work(64, 32, 4, 6)
    assert nbytes == (4 * 64 * 32 + 6 * (64 + 32)) * 2
    assert flops == 2 * 6 * 64 * 32
    assert moe_gemm.layer_seconds(64, 32, 4, 6, 3) == 3 * peaks.least_seconds(nbytes, flops)
    assert moe_gemm.layer_seconds(64, 32, 4, 6, 2) == 2 * peaks.least_seconds(nbytes, flops)


def test_flash_decode_paged_counts_resident_kv():
    nbytes, flops = flash_decode_paged.launch_work([10, 3], 4, 2, 16)
    assert nbytes == (2 * 13 * 2 * 16 + 2 * 2 * 4 * 16) * 2
    assert flops == 4 * 13 * 4 * 16


def _cfg(arch):
    c = dict(spec.layout_module({"architecture": arch}).TINY, architecture=arch,
             rms_norm_eps=1e-6)
    if arch == "qwen3_moe":
        c["num_experts"] = c.pop("num_experts", 8)
    else:
        c["first_k_dense_replace"] = 1
    return c


def test_model_flops_by_hand_gqa():
    c = _cfg("qwen3_moe")                  # d 64, 4/2 heads x 16, 8 experts top-2, f 32
    d, L = 64, 2
    proj = d * (4 + 2 * 2) * 16 + 4 * 16 * d
    per_layer = 2 * proj + 4 * 4 * 16 * 5 + 2 * d * 8 + 6 * d * 32 * 2
    assert model_flops.token(c, 5, False) == L * per_layer
    assert model_flops.token(c, 5, True) == L * per_layer + 2 * d * 128
    # a prompt of 3: contexts 1 + 2 + 3, one sampled position
    want = sum(model_flops.token(c, n, False) for n in (1, 2, 3)) + 2 * d * 128
    assert model_flops.prefill(c, 3) == pytest.approx(want)
    assert model_flops.decode(c, [5, 7]) == model_flops.token(c, 5, True) + \
        model_flops.token(c, 7, True)


def test_model_flops_by_hand_mla():
    c = _cfg("deepseek_v2")                 # 1 dense + 2 MoE layers
    d, h = 64, 4
    proj = d * 32 + 32 * h * 24 + d * (16 + 8) + 16 * h * 32 + h * 16 * d
    attn = 2 * proj + 2 * h * 24 * 9 + 2 * h * 16 * 9
    dense = 6 * d * 128
    moe = 2 * d * 8 + 6 * d * 32 * (2 + 2)
    assert model_flops.token(c, 9, False) == 3 * attn + dense + 2 * moe


def test_trace_reduce_busy_union_and_labelled_gaps():
    spans = [("step", 0, 100), ("prefill", 10, 40), ("decode", 50, 90), ("step", 120, 200)]
    device = [(15, 35, "tc_gemm_kernel<4>"), (30, 40, "tc_gemm_kernel<4>"),
              (60, 80, "rt::split::split_kernel"), (130, 140, "memcpy"), (195, 205, "late")]
    s = trace.reduce(device, spans)
    assert s.window_s == pytest.approx(200e-9)
    assert s.busy_s == pytest.approx((25 + 20 + 10 + 5) * 1e-9)
    assert s.outside_s == pytest.approx(5e-9)
    assert s.seconds_of("tc_gemm_kernel") == pytest.approx(30e-9)
    # idle: [0,15) [40,60) [80,130) [140,195), cut at the host spans' edges
    pieces = sorted((lbl, round(sec * 1e9)) for lbl, sec in s.gaps)
    assert pieces == sorted([("scheduler", 10), ("prefill", 5), ("scheduler", 10), ("decode", 10),
                             ("decode", 10), ("scheduler", 10), ("harness", 20),
                             ("scheduler", 10), ("scheduler", 55)])
    assert sum(sec for _, sec in s.gaps) == pytest.approx(s.window_s - s.busy_s)
    b = s.breakdown()
    assert b["device_ops"][0][0] == "tc_gemm_kernel<4>" and b["idle_gaps"][0][0] == "scheduler"
    assert trace.reduce([], spans) is None


def test_device_events_leave_out_host_events_and_annotations():
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def ev(name, dev, annotation=False):
        return SimpleNamespace(name=lambda: name, start_ns=lambda: 5, duration_ns=lambda: 3,
                               device_type=lambda: dev, is_user_annotation=lambda: annotation)
    got = trace.device_events([ev("k", DeviceType.CUDA), ev("cudaLaunchKernel", DeviceType.CPU),
                               ev("range", DeviceType.CUDA, True)])
    assert got == [(5, 8, "k")]
