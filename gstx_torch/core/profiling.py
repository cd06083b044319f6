"""Tracing: the port's spans and counters, and ``trace``, the counterpart of
``gstx/core/profiling.py``'s ``trace`` (line 19) on ``torch.profiler``.

The registry keeps, in memory, named spans of host time and counters:

    with profiling.span("gstx:decode.step"):
        ...
    profiling.count("decode.steps")

Collection is process-wide.  It is on while a ``torch.profiler`` records
(the module flag ``torch.autograd.profiler._is_profiler_enabled``, which
every thread reads alike: the thread-local
``torch.autograd._profiler_enabled()`` reads False on every thread but
the one that started the profiler, a loader's worker), and inside
:func:`collecting`.  While it is off, :func:`span` returns one shared no-op
context after one flag check, and :func:`count` returns after it.

While collecting, a span records its name, its start and end in Unix
nanoseconds (``time.time_ns``, the clock of the profiler's events), the
index of its parent span on the same thread, the index of the thread's
outermost open span (its root: an engine batch, an eval batch, a train
step; the spans of one batch share it) and its thread.  On a thread whose
profiler records, it also opens a profiler range of its name
(``torch._C._profiler._RecordFunctionFast``), so that it lands in the same
trace as the kernels, as a host op, and labels the device's idle gaps
there.  It is not a ``torch.profiler.record_function``: that is a user
annotation, which the profiler mirrors onto the device's timeline as a
range over the kernels it launched, and a reader of the trace would count
the mirror as device time.  A span opened while collecting is recorded
whole, whenever it ends.  Up to ``MAX_SPANS`` spans are kept; beyond, only
the totals by name grow, and the counter ``dropped_spans`` says how many
were not kept.

:func:`snapshot` gives, by span name, ``count``, ``total_s`` and
``self_s`` (a span's duration less the time its child spans cover), and
the counters.  ``trace(trace_dir)`` writes ``trace.json`` and, beside it,
``spans.json``: the spans, the snapshot, the kernels' launch counts and
the peak device memory.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Optional

import torch
from torch.autograd import profiler as _autograd_profiler

MAX_SPANS = 1_000_000
FIELDS = ("name", "start_ns", "end_ns", "parent", "root", "thread")


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Frame:
    """An open span on its thread's stack."""
    __slots__ = ("name", "start", "record", "index", "root", "child",
                 "generation")


class _Span:
    __slots__ = ("_reg", "_name", "_wait", "_rf", "_frame")

    def __init__(self, reg: "Registry", name: str, wait: Optional[str]):
        self._reg, self._name, self._wait = reg, name, wait

    def __enter__(self):
        # the profiler's event opens first and closes last, so that the
        # recorded span lies inside it
        self._rf = None
        if torch.autograd._profiler_enabled():
            self._rf = torch._C._profiler._RecordFunctionFast(self._name)
            self._rf.__enter__()
        self._frame = self._reg._open(self._name)
        return self

    def __exit__(self, *exc):
        self._reg._close(self._frame, self._wait)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


class _Task:
    """A span for a leaf of work that may begin before collection does (a
    loader's batch): it always takes its start (one clock read), and if it
    ends while collecting it is recorded from no earlier than the
    collection's start."""
    __slots__ = ("_reg", "_name", "_start")

    def __init__(self, reg: "Registry", name: str):
        self._reg, self._name = reg, name

    def __enter__(self):
        self._start = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self._reg.active():
            self._reg._leaf(self._name, self._start, time.time_ns())
        return False


class Registry:
    """Spans and counters of one process (the module's functions use
    :data:`REGISTRY`); thread-safe."""

    def __init__(self, max_spans: int = MAX_SPANS):
        self.max_spans = max_spans
        self._lock = threading.Lock()
        self._local = threading.local()
        self._forced = 0
        self._generation = 0
        self.reset()

    # ------------------------------------------------------------------ #
    def active(self) -> bool:
        """Whether spans and counts are collected now."""
        return _autograd_profiler._is_profiler_enabled or self._forced > 0

    def span(self, name: str):
        """A context that records a span of ``name`` while collecting."""
        if not (_autograd_profiler._is_profiler_enabled or self._forced):
            return _NOOP
        return _Span(self, name, None)

    def sync_span(self, name: str, prefix: str):
        """A span around a read that blocks the host on the device; it also
        adds 1 to ``<prefix>.host_syncs`` and its seconds to
        ``<prefix>.sync_wait_s``."""
        if not (_autograd_profiler._is_profiler_enabled or self._forced):
            return _NOOP
        return _Span(self, name, prefix)

    def task(self, name: str):
        """A leaf span of work that may have begun before collection (see
        :class:`_Task`); no span may open inside it."""
        return _Task(self, name)

    def count(self, name: str, n=1) -> None:
        """Add ``n`` to the counter ``name`` while collecting."""
        if not (_autograd_profiler._is_profiler_enabled or self._forced):
            return
        with self._lock:
            self._mark()
            self._counters[name] = self._counters.get(name, 0) + n

    @contextlib.contextmanager
    def collecting(self):
        """Collect inside the block, with or without a profiler."""
        with self._lock:
            self._forced += 1
            self._mark()
        try:
            yield self
        finally:
            with self._lock:
                self._forced -= 1

    def reset(self) -> None:
        """Forget every span and counter (spans open now are not recorded
        when they close)."""
        with self._lock:
            self._generation += 1
            self._records = []
            self._totals = {}
            self._counters = {}
            self._since = None

    def snapshot(self) -> dict:
        """``{"spans": {name: {count, total_s, self_s}}, "counters":
        {name: value}}``."""
        with self._lock:
            spans = {n: {"count": c, "total_s": t / 1e9, "self_s": s / 1e9}
                     for n, (c, t, s) in self._totals.items()}
            return {"spans": spans, "counters": dict(self._counters)}

    def records(self) -> list:
        """The kept spans, in the order they opened: one list of
        :data:`FIELDS` each (``end_ns`` None while open; ``parent`` None
        for a thread's outermost span)."""
        with self._lock:
            return [list(r) for r in self._records]

    # ------------------------------------------------------------------ #
    def _mark(self):
        # the start of this collection, until reset(): its first span or
        # count (under the profiler) or the start of collecting()
        if self._since is None:
            self._since = time.time_ns()

    def _stack(self):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _parent(self, stack):
        parent = stack[-1] if stack else None
        if parent is not None and parent.generation != self._generation:
            return None  # opened before a reset
        return parent

    def _keep(self, name, start, end, parent):
        """Keep a span record (under the lock); its index, or None beyond
        the cap."""
        if len(self._records) >= self.max_spans:
            self._counters["dropped_spans"] = \
                self._counters.get("dropped_spans", 0) + 1
            return None, None
        index = len(self._records)
        root = index if parent is None or parent.root is None \
            else parent.root
        record = [name, start, end,
                  None if parent is None else parent.index, root,
                  threading.get_ident()]
        self._records.append(record)
        return index, record

    def _open(self, name) -> _Frame:
        stack = self._stack()
        f = _Frame()
        f.name, f.child = name, 0
        with self._lock:
            self._mark()
            f.start = time.time_ns()
            f.generation = self._generation
            f.index, f.record = self._keep(name, f.start, None,
                                           self._parent(stack))
            f.root = None if f.record is None else f.record[4]
        stack.append(f)
        return f

    def _close(self, f: _Frame, wait: Optional[str]):
        end = time.time_ns()
        stack = self._stack()
        if stack and stack[-1] is f:
            stack.pop()
        elif f in stack:
            stack.remove(f)  # closed out of order
        dur = end - f.start
        if stack:
            stack[-1].child += dur
        with self._lock:
            if f.generation != self._generation:
                return
            if f.record is not None:
                f.record[2] = end
            self._total(f.name, dur, dur - f.child)
            if wait is not None:
                c = self._counters
                c[wait + ".host_syncs"] = c.get(wait + ".host_syncs", 0) + 1
                c[wait + ".sync_wait_s"] = \
                    c.get(wait + ".sync_wait_s", 0.0) + dur / 1e9

    def _leaf(self, name, start, end):
        stack = self._stack()
        with self._lock:
            self._mark()
            start = min(max(start, self._since), end)
            parent = self._parent(stack)
            if parent is not None:
                parent.child += end - start
            self._keep(name, start, end, parent)
            self._total(name, end - start, end - start)

    def _total(self, name, dur, self_ns):
        t = self._totals.get(name)
        if t is None:
            t = self._totals[name] = [0, 0, 0]
        t[0] += 1
        t[1] += dur
        t[2] += self_ns


REGISTRY = Registry()
span = REGISTRY.span
sync_span = REGISTRY.sync_span
task = REGISTRY.task
count = REGISTRY.count
collecting = REGISTRY.collecting
snapshot = REGISTRY.snapshot
records = REGISTRY.records
reset = REGISTRY.reset


def _rank_suffix() -> str:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return f".rank{dist.get_rank()}"
    return ""


def _write_spans(path: str) -> None:
    """``spans.json``: the kept spans (:data:`FIELDS`), the snapshot, the
    kernels' launch counters as they stand and this process's peak device
    memory (None without a card)."""
    from gstx_torch import kernels

    launches = {k: n for c in kernels.launch_counters() for k, n in c.items()}
    peak = torch.cuda.max_memory_allocated() \
        if torch.cuda.is_available() else None
    with open(path, "w") as f:
        json.dump({"fields": list(FIELDS), "spans": records(),
                   "snapshot": snapshot(), "launches": launches,
                   "max_memory_allocated": peak}, f)


@contextlib.contextmanager
def trace(trace_dir: Optional[str]):
    """Record a host and device trace of the block into ``trace_dir`` as a
    Chrome trace (``trace.json``, viewable in Perfetto or
    chrome://tracing), and the registry's spans of the block beside it
    (``spans.json``, see :func:`_write_spans`; it forgets what it held
    before); a no-op when ``trace_dir`` is empty.  The device is traced
    when a card is present.  Under several ranks each writes its own
    (``trace.rank<N>.json``, ``spans.rank<N>.json``).

        with trace("/tmp/gstx_trace"):
            run_batches()
    """
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    reset()
    with profile(activities=activities) as prof:
        yield
    rank = _rank_suffix()
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace{rank}.json"))
    _write_spans(os.path.join(trace_dir, f"spans{rank}.json"))
