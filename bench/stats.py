"""End-to-end metric arithmetic on the harness's own token timestamps.

A request's first token is stamped at the end of the engine step in which
its generated count first became 1, each later token at the end of the
step that raised it.  TTFT counts from the time the request was due; a
request due in the window with no first token at the close enters at
(close - due).  The gaps between output tokens are every gap whose later
token lands in the window, and, for a request still unfinished at the
close, the open gap from its last token to the close; their mean is the
mean inter-token latency, stalls included.  Percentiles are the
program's (``serving/metrics.py``: ``np.percentile``, linear)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Req:
    rid: int
    due: float
    prompt: np.ndarray
    out_len: int
    client: int = 0
    start_call: Optional[float] = None     # the backend.start call for it began
    stamps: List[float] = dataclasses.field(default_factory=list)
    served: List[int] = dataclasses.field(default_factory=list)
    finished: Optional[float] = None
    refused: bool = False


def percentile(xs, q: float) -> Optional[float]:
    return float(np.percentile(xs, q)) if len(xs) else None


def due_in(reqs: Dict[int, Req], t_open: float, t_close: float) -> List[Req]:
    return [r for r in reqs.values() if t_open <= r.due < t_close]


def ttfts(reqs: Dict[int, Req], t_open: float, t_close: float) -> List[float]:
    out = []
    for r in due_in(reqs, t_open, t_close):
        first = r.stamps[0] if r.stamps and r.stamps[0] < t_close else t_close
        out.append(first - r.due)
    return out


def itls(reqs: Dict[int, Req], t_open: float, t_close: float) -> List[float]:
    out = []
    for r in reqs.values():
        s = r.stamps
        for a, b in zip(s, s[1:]):
            if t_open <= b < t_close:
                out.append(b - a)
        done = r.finished is not None and r.finished < t_close
        live = [t for t in s if t < t_close]
        if live and not done and live[-1] < t_close:
            out.append(t_close - live[-1])
    return out


def output_tokens(reqs: Dict[int, Req], t_open: float, t_close: float) -> int:
    return sum(1 for r in reqs.values() for t in r.stamps if t_open <= t < t_close)


def end_to_end(reqs: Dict[int, Req], t_open: float, t_close: float) -> Dict[str, float]:
    """Every end-to-end metric the harness knows, by name."""
    tt = ttfts(reqs, t_open, t_close)
    it = itls(reqs, t_open, t_close)
    out = {}
    if tt:
        out["ttft_p50_ms"] = 1e3 * percentile(tt, 50)
        out["ttft_p95_ms"] = 1e3 * percentile(tt, 95)
    if it:
        out["itl_p95_ms"] = 1e3 * percentile(it, 95)
        out["itl_mean_ms"] = 1e3 * float(np.mean(it))
    out["output_tok_per_s"] = output_tokens(reqs, t_open, t_close) / (t_close - t_open)
    return out
