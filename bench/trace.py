"""The traced run's device trace: a bounded sub-window of the measured
window under ``torch.profiler``, reduced to the device's busy time, its
idle gaps labelled by the harness's own host spans, and the device time of
the kernels the roofline metrics read.

The profiler records device activity only; the harness keeps its own host
spans on the profiler's clock (``time.time_ns``) while it runs: ``step``
(``Engine.step``), ``prefill`` (``backend.start``), ``decode``
(``backend.decode``) and ``expert_level`` (the level's ``observe`` and
``tick`` and the weight relocation).  The trace is read after the window
closes, so reading it costs the window nothing.  An idle stretch is labelled by the innermost span
it covers, cut where one opens or closes: ``prefill``, ``decode``,
``expert_level``, ``scheduler`` (inside a step, outside those) or
``harness`` (between steps).
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

SPANS = ("prefill", "decode", "expert_level")
TOP = 10


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]          # device seconds by kernel name
    gaps: List[Tuple[str, float]]       # every idle gap (label, seconds)
    outside_s: float = 0.0              # device seconds outside the host window

    def seconds_of(self, *parts: str) -> float:
        """Device seconds of the kernels whose name holds any of ``parts``."""
        return sum(s for k, s in self.kernel_s.items() if any(p in k for p in parts))

    def breakdown(self) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.gaps, key=lambda g: -g[1])[:TOP]
        return {"device_ops": [[k[:160], s] for k, s in ops],
                "idle_gaps": [[k, s] for k, s in gaps]}


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{what}_us")() * 1000)


def _merge(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class _Cover:
    """Which of a family of disjoint host spans holds an instant."""

    def __init__(self, spans: List[Tuple[int, int]]):
        self.spans = sorted(spans)
        self.starts = [a for a, _ in self.spans]

    def holds(self, t: int) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and self.spans[i][0] <= t < self.spans[i][1]


def device_events(events) -> List[Tuple[int, int, str]]:
    """(start ns, end ns, name) of each device operation of a trace."""
    from torch.autograd import DeviceType
    out = []
    for ev in events:
        if ev.device_type() == DeviceType.CUDA and not getattr(
                ev, "is_user_annotation", lambda: False)():
            start = _ns(ev, "start")
            out.append((start, start + _ns(ev, "duration"), ev.name()))
    return out


def reduce(device: List[Tuple[int, int, str]],
           spans: List[Tuple[str, int, int]]) -> Optional[Summary]:
    """The summary of a sub-window's device operations and the harness's
    host spans, or None when the trace holds no device event (the card's
    profiler now and then hands back an empty trace) or no step."""
    host: Dict[str, List[Tuple[int, int]]] = {n: [] for n in SPANS + ("step",)}
    for name, a, b in spans:
        host[name].append((a, b))
    if not device or not host["step"]:
        return None
    w0 = min(a for a, _ in host["step"])
    w1 = max(b for _, b in host["step"])
    kernel_s: Dict[str, float] = {}
    clipped = []
    outside = 0
    for a, b, name in device:
        outside += max(0, min(b, w0) - a) + max(0, b - max(a, w1))
        a, b = max(a, w0), min(b, w1)
        if b > a:
            clipped.append((a, b))
            kernel_s[name] = kernel_s.get(name, 0.0) + (b - a) * 1e-9
    busy = _merge(clipped)
    covers = {n: _Cover(v) for n, v in host.items()}
    cuts = sorted({x for v in host.values() for iv in v for x in iv})
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = []
    for a, b in zip(edges[0::2], edges[1::2]):
        # an idle gap is cut where a host span opens or closes, each piece
        # labelled by what the host was doing through it
        i, j = bisect.bisect_right(cuts, a), bisect.bisect_left(cuts, b)
        points = [a] + cuts[i:j] + [b]
        for p, q in zip(points, points[1:]):
            if q > p:
                label = next((n for n in SPANS if covers[n].holds(p)),
                             "scheduler" if covers["step"].holds(p) else "harness")
                gaps.append((label, (q - p) * 1e-9))
    return Summary(window_s=(w1 - w0) * 1e-9,
                   busy_s=sum(b - a for a, b in busy) * 1e-9,
                   kernel_s=kernel_s, gaps=gaps, outside_s=outside * 1e-9)


class Profiler:
    """Sub-windows of the run under ``torch.profiler`` (device activity
    only); ``stop`` synchronises first, so every kernel the sub-window
    launched is in its trace, and keeps the device operations unread
    until ``reduce``."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None

    def warm(self) -> None:
        """Start and stop once in set-up: the first start loads the tracing
        library, which would otherwise stall the window."""
        self.start()
        self.torch.ones(1, device="cuda").add_(1)
        self.stop()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()

    def stop(self) -> List[Tuple[int, int, str]]:
        self.torch.cuda.synchronize()
        self.prof.stop()
        out = device_events(self.prof.profiler.kineto_results.events())
        self.prof = None
        return out
