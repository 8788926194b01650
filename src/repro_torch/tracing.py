"""In-memory spans and counters of the serving path, on exactly while a
``torch.profiler`` records in the process.

``Engine.step`` reads the profiler's state once, at its start (``poll``):
a step that finds it recording after it was not opens a *session*.  The
session closes at the first step, span site, counted sync or ``last()``
that finds the profiler stopped.  There is no other switch.  While a
session is open each span site records its name, its start and end on
``time.time_ns`` (the clock the profiler's events carry, so a device trace
and the spans line up) and its parent, and the counters add up at the same
sites.  With no session a span site reads one module flag and gets the
shared no-op ``NULL`` back.

Spans, parent first:

  step             ``Engine.step``: schedule, prefill, decode,
                   expert.observe, expert.tick, expert.relocate
  prefill          ``TorchBackend.start``: prefill.model, prefill.kv_write,
                   prefill.readback
  decode           ``TorchBackend.decode``: decode.inputs, decode.model,
                   decode.readback, decode.stats
  layer            ``models.model._run_stack``, one a layer:
                   layer.placement, attention, moe or ffn
  moe              ``models.moe.moe_apply``: route, dispatch, experts,
                   experts.shared, combine

Counters: ``host_syncs`` by the innermost open span (every call that
torch's CUDA sync debug mode reports: reads to the host, copies from
pageable memory, stream syncs; ``torch.cuda.synchronize`` is not among
them), ``decode_rows_live`` against ``decode_rows``, the rows a decode
step computes, and ``mla_decode_latent`` against ``mla_decode_layers``, the
MLA decode calls taken in latent space among all of them
(``models.attention.mla_decode``).

An operator profiles an engine, then puts the profile's idle gaps down to
the spans open at their instants (``Session.label``) and reads the syncs
by span (``Session.syncs_by_path``)::

    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]):
        for _ in range(n):
            engine.step(now)
    session = repro_torch.tracing.last()
"""
from __future__ import annotations

import time
import warnings
from typing import Dict, List, Optional

SYNC_MESSAGE = "called a synchronizing CUDA operation"

_on = False                           # a session is open
_session: Optional["Session"] = None  # the open session
_last: Optional["Session"] = None     # the newest session, open or closed
_recording = None                     # torch's profiler-state probe, bound at the first poll


class _Null:
    """The span a site gets with no session: records nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL = _Null()


class Span:
    """One recorded span; ``parent`` is the index of the enclosing span in
    ``Session.spans``, -1 for none."""
    __slots__ = ("name", "start", "end", "parent", "_session")

    def __init__(self, session: "Session", name: str):
        self._session = session
        self.name = name
        self.parent = -1
        self.start = self.end = 0

    def __enter__(self):
        s = self._session
        self.parent = s._stack[-1] if s._stack else -1
        s._stack.append(len(s.spans))
        s.spans.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.time_ns()
        self._session._stack.pop()
        self._session = None
        return False


class Session:
    """The spans and counters recorded while one profiler ran."""

    def __init__(self):
        self.start = time.time_ns()
        self.end: Optional[int] = None
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self.syncs: Dict[int, int] = {}             # span index (-1: none open) -> syncs
        self._stack: List[int] = []
        self._warnings = None
        self._sync_mode = None

    # -------------------------------------------------------------- recording
    def open(self) -> None:
        """Count synchronising CUDA calls: torch's sync debug mode warns at
        each (on a CUDA process only), and the warning is counted here and
        never shown."""
        self._warnings = warnings.catch_warnings()
        self._warnings.__enter__()
        warnings.filterwarnings("always", message=SYNC_MESSAGE)
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if SYNC_MESSAGE not in str(message) or _session is not self:
                shown(message, category, filename, lineno, file, line)
            elif _recording():
                self.count_sync()
            else:
                _close()

        warnings.showwarning = show
        # torch warns once that the mode is a prototype: nothing is printed
        warnings.filterwarnings("ignore", message="Synchronization debug mode")
        import torch
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            self._sync_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")

    def close(self) -> None:
        if self._sync_mode is not None:
            import torch
            torch.cuda.set_sync_debug_mode(self._sync_mode)
            self._sync_mode = None
        self._warnings.__exit__(None, None, None)
        self.end = time.time_ns()

    def count(self, name: str, n: int) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def count_sync(self) -> None:
        i = self._stack[-1] if self._stack else -1
        self.syncs[i] = self.syncs.get(i, 0) + 1

    # -------------------------------------------------------------- reading
    def find(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def path(self, i: int) -> str:
        """``step/decode/decode.model/layer/moe/route`` for span ``i``."""
        names = []
        while i >= 0:
            names.append(self.spans[i].name)
            i = self.spans[i].parent
        return "/".join(reversed(names))

    def within(self, i: int, name: str) -> bool:
        """Span ``i`` is a ``name`` span or lies inside one."""
        while i >= 0:
            if self.spans[i].name == name:
                return True
            i = self.spans[i].parent
        return False

    def syncs_within(self, name: str) -> int:
        return sum(n for i, n in self.syncs.items() if i >= 0 and self.within(i, name))

    def syncs_by_path(self) -> Dict[str, int]:
        """Host syncs by the path of their innermost span ('' outside any)."""
        out: Dict[str, int] = {}
        for i, n in self.syncs.items():
            p = self.path(i) if i >= 0 else ""
            out[p] = out.get(p, 0) + n
        return out

    def ns_within(self, child: str, name: str) -> int:
        """Summed duration of the ``child`` spans that lie inside a ``name`` span."""
        return sum(s.end - s.start for s in self.spans
                   if s.name == child and self.within(s.parent, name))

    def count_within(self, child: str, name: str) -> int:
        return sum(1 for s in self.spans if s.name == child and self.within(s.parent, name))

    def label(self, t_ns: int) -> Optional[str]:
        """The path of the innermost span open at ``t_ns``, None where no
        span is.  Spans nest, so the innermost one holding ``t_ns`` is the
        last one started by then or one of its parents."""
        lo, hi = 0, len(self.spans)
        while lo < hi:
            mid = (lo + hi) // 2
            if self.spans[mid].start <= t_ns:
                lo = mid + 1
            else:
                hi = mid
        i = lo - 1
        while i >= 0:
            s = self.spans[i]
            if s.start <= t_ns < s.end:
                return self.path(i)
            i = s.parent
        return None


# ------------------------------------------------------------------ module API

def poll() -> bool:
    """Open a session when a profiler has started since the last poll,
    close it when the profiler has stopped.  Returns whether one records."""
    global _recording
    if _recording is None:
        import torch
        _recording = torch._C._autograd._profiler_enabled
    recording = _recording()
    if recording and not _on:
        _open()
    elif not recording and _on:
        _close()
    return recording


def _open() -> None:
    global _on, _session, _last
    _session = _last = Session()
    _session.open()
    _on = True


def _close() -> None:
    global _on, _session
    _on = False
    s, _session = _session, None
    s.close()


def last() -> Optional[Session]:
    """The newest session, closed first if the profiler has stopped."""
    if _on and not _recording():
        _close()
    return _last


def span(name: str):
    """A span to enter with ``with``; ``NULL`` when no session is open.  A
    session whose profiler has stopped closes here."""
    if not _on:
        return NULL
    if not _recording():
        _close()
        return NULL
    return Span(_session, name)


def count(name: str, n: int) -> None:
    if _on:
        _session.count(name, n)
