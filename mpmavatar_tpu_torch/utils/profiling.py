"""Spans and counters of the program's own phases, and a trace export.

``span(name)`` marks a phase where the work happens (a substep's stress
or grid stage, the material step's backward, a twin's backward);
``count(name, n)`` adds to a named counter.  The port's counters:
``windows.evaluated``, ``windows.live`` and ``windows.fused`` (a
substep's release windows, ``core/stepping.py::count_windows``),
``substep.graphed`` (``sim/substep_graph.py::SubstepGraph.run``: one
for each substep replayed from a captured CUDA graph, none for an eager
one) and ``binding.gathered_slots`` (``render/gaussians.py::bound_rows``).
Tracing is on while ``enable()`` holds and while a ``torch.profiler``
records, except inside ``paused()`` (a graph's capture).  Off, the
default, ``span`` makes one check and hands back one shared no-op
object (no ``record_function``, no clock, no allocation) and ``count``
returns at once.

On, each span records its name, start, end, its parent (the span open
around it on the same thread: autograd runs backward and checkpoint
recompute on threads of its own) and its thread.  Start and end are on
the profiler's clock: Unix-epoch nanoseconds, in which Kineto stamps its
events, so a span lines up with the device intervals of the same trace.
While a profiler records, each span also opens a ``record_function``
range of its name, so it shows in the trace, and the profiler's idle gaps
can be put down to the span the host was in.

Each stretch during which tracing is on is a session; a new one starts
when tracing turns on after being off (found at the next span or count
once a profiler has stopped).  ``snapshot()`` reads the newest session:
for each span name its count, total and self nanoseconds (the total less
what its children on the same thread cover), the counters, and the
kernel launches counted by ``ops/_build.py``.  ``spans()`` gives the raw
spans, kept up to ``MAX_SPANS`` a session; past that only the
aggregates grow and ``spans.dropped`` counts what was not kept.

``trace(log_dir)`` records a ``torch.profiler`` trace of a block, the
spans in it, as a Chrome trace for Perfetto.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import NamedTuple

import torch

MAX_SPANS = 1_000_000

# whether a profiler records on this thread: one C call
_profiling = torch._C._autograd._profiler_enabled
# record_function's range, opened from C: a tenth of
# torch.profiler.record_function's cost, which dispatches two ops that the
# profiler records besides
_range = torch._C._profiler._RecordFunctionFast
_clock = time.time_ns      # Unix-epoch ns, the clock of Kineto's events


class Span(NamedTuple):
    """A kept span: ``parent`` is its parent's index in ``spans()``, or
    None."""
    name: str
    start_ns: int
    end_ns: int
    parent: int | None
    thread: int


class _Session:
    def __init__(self):
        self.lock = threading.Lock()
        self.ids = itertools.count()    # a span's index, taken at entry
        self.raw = {}           # index -> (name, start, end, parent, thread)
        self.totals = {}        # name -> [count, total_ns, self_ns]
        self.counters = {}


class _Off:
    """The shared span of tracing off.  Its ``__enter__`` and ``__exit__``
    are C functions that ``with`` calls without binding the object (a
    builtin method is no descriptor): ``"".format`` takes any arguments
    and returns "", which lets an exception through.  Python methods
    would add a third to the cost of a span with tracing off."""
    __slots__ = ()
    __enter__ = __exit__ = "".format


_OFF = _Off()
_local = threading.local()      # .stack: the thread's open spans
_lock = threading.Lock()
_enabled = 0                    # depth of enable()
_paused = 0                     # depth of paused()
_on = False                     # tracing was on at the last check
_session: _Session | None = None


def _new_session():
    global _session, _on
    _session, _on = _Session(), True


def _session_on() -> _Session:
    """The session to record into, tracing being on."""
    if not _on:
        with _lock:
            if not _on:
                _new_session()
    return _session


class _Span:
    __slots__ = ("name", "session", "rf", "index", "parent", "start",
                 "child_ns", "stack")

    def __init__(self, name, session, prof):
        self.name, self.session = name, session
        self.rf = _range(name) if prof else None

    # the span is stamped outside its record_function range and its
    # bookkeeping, so that their cost is the span's and not its parent's
    def __enter__(self):
        self.start = _clock()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        s = self.session
        top = stack[-1] if stack else None
        self.parent = top.index if top is not None and top.session is s \
            else None
        self.index = next(s.ids)
        if self.rf is not None:
            self.rf.__enter__()
        self.child_ns, self.stack = 0, stack
        stack.append(self)
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        stack, s = self.stack, self.session
        stack.pop()
        end = _clock()
        total = end - self.start
        if stack and stack[-1].session is s:
            stack[-1].child_ns += total
        with s.lock:
            if self.index < MAX_SPANS:
                s.raw[self.index] = (self.name, self.start, end, self.parent,
                                     threading.get_ident())
            else:
                s.counters["spans.dropped"] = \
                    s.counters.get("spans.dropped", 0) + 1
            agg = s.totals.get(self.name)
            if agg is None:
                agg = s.totals[self.name] = [0, 0, 0]
            agg[0] += 1
            agg[1] += total
            agg[2] += total - self.child_ns
        return False


def span(name: str):
    """A context manager that marks the block as the phase ``name``."""
    global _on
    prof = _profiling()
    if prof or _enabled:
        return _OFF if _paused else _Span(name, _session_on(), prof)
    _on = False
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    global _on
    if not (_enabled or _profiling()):
        _on = False
        return
    if _paused:
        return
    s = _session_on()
    with s.lock:
        s.counters[name] = s.counters.get(name, 0) + n


def on() -> bool:
    """Whether tracing is on: work done only to feed a counter checks this
    first."""
    global _on
    if _enabled or _profiling():
        return not _paused
    _on = False
    return False


@contextlib.contextmanager
def enable():
    """Tracing on for the block, without a profiler.  A new session starts
    unless tracing is on already."""
    global _enabled, _on
    with _lock:
        if not _enabled and not (_on and _profiling()):
            _new_session()
        _enabled += 1
    try:
        yield
    finally:
        with _lock:
            _enabled -= 1
            if not _enabled and not _profiling():
                _on = False


@contextlib.contextmanager
def paused():
    """No span or count on any thread in the block, and the session kept,
    whether tracing is on or off: a CUDA graph's capture, which runs no
    work (its replays do, and record their own spans and counts)."""
    global _paused
    with _lock:
        _paused += 1
    try:
        yield
    finally:
        with _lock:
            _paused -= 1


def snapshot() -> dict:
    """The newest session: ``spans`` (name -> count, total_ns, self_ns),
    ``counters`` and ``launches`` (kernel -> launches, from
    ``ops/_build.py``)."""
    from ..ops import _build
    s = _session
    spans, counters = {}, {}
    if s is not None:
        with s.lock:
            spans = {k: {"count": c, "total_ns": t, "self_ns": self_ns}
                     for k, (c, t, self_ns) in s.totals.items()}
            counters = dict(s.counters)
    return {"spans": spans, "counters": counters,
            "launches": _build.launch_counts()}


def spans() -> dict:
    """The newest session's kept spans that have closed, by index in the
    order they opened (``Span.parent`` is such an index)."""
    s = _session
    if s is None:
        return {}
    with s.lock:
        return {i: Span(*s.raw[i]) for i in sorted(s.raw)}


def reset() -> None:
    """Clear the spans, the counters and the launch counts."""
    from ..ops import _build
    global _session
    with _lock:
        if _session is not None:
            _session = _Session()
    _build.reset_launch_counts()


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the block (the CPU, and the
    CUDA device when there is one), the spans as ranges in it, into
    ``log_dir`` as a Chrome trace (``trace.json``), viewable in Perfetto
    or chrome://tracing."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
