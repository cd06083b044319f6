"""The port's span and counter registry (``gstx_torch.core.profiling``):
off means nothing entered and nothing counted, the stamps on the
profiler's clock, nesting and self time, threads, the cap, and a task
begun before collection."""

import sys
import threading
import time

import torch
from torch.profiler import ProfilerActivity, profile

import torch_port_harness  # noqa: F401  (the CPU thread rule)
from gstx_torch.core import profiling

CLOCK_NS = 50_000  # a stamp against its profiler event


def test_off_enters_no_profiler_range_and_counts_nothing(monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        lambda name: entered.append(name))
    reg = profiling.Registry()
    assert not reg.active()
    assert reg.span("a") is reg.span("b") is profiling.span("c")
    assert reg.sync_span("a", "engine") is reg.span("a")
    with reg.span("a"), reg.sync_span("b", "engine"), reg.task("t"):
        reg.count("n", 5)
    assert entered == []
    assert reg.snapshot() == {"spans": {}, "counters": {}}
    assert reg.records() == []


def test_span_stamps_lie_inside_the_profiler_events():
    """Each span is an op event of the trace (not a user annotation, which
    the profiler would mirror onto the device's timeline), and its
    in-memory stamps lie inside that event."""
    reg = profiling.Registry()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert reg.active()
        for i in range(5):
            with reg.span(f"gstx:outer{i}"):
                with reg.span(f"gstx:inner{i}"):
                    torch.ones(64).sum()
    events = {e.name(): (e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if not e.is_user_annotation()}
    recs = reg.records()
    assert len(recs) == 10
    for name, start, end, *_ in recs:
        lo, hi = events[name]
        assert lo - CLOCK_NS <= start <= end <= hi + CLOCK_NS, name
    assert not reg.active()


def test_nesting_parent_root_and_self_time():
    reg = profiling.Registry()
    with reg.collecting():
        with reg.span("outer"):
            with reg.span("inner"):
                with reg.span("deep"):
                    time.sleep(0.002)
            with reg.span("inner"):
                time.sleep(0.001)
        with reg.span("second"):
            pass
    names = [r[0] for r in reg.records()]
    parents = [r[3] for r in reg.records()]
    roots = [r[4] for r in reg.records()]
    assert names == ["outer", "inner", "deep", "inner", "second"]
    assert parents == [None, 0, 1, 0, None]
    assert roots == [0, 0, 0, 0, 4]
    snap = reg.snapshot()["spans"]
    dur = {}
    for name, start, end, *_ in reg.records():
        dur.setdefault(name, []).append((end - start) / 1e9)
    assert snap["inner"]["count"] == 2
    assert abs(snap["outer"]["self_s"]
               - (dur["outer"][0] - sum(dur["inner"]))) < 1e-9
    assert abs(snap["inner"]["self_s"]
               - (sum(dur["inner"]) - dur["deep"][0])) < 1e-9
    assert snap["deep"]["self_s"] == snap["deep"]["total_s"]


def test_counters_from_threads_sum_exactly_and_threads_collect():
    reg = profiling.Registry()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with reg.collecting():
            def work():
                for _ in range(2000):
                    reg.count("n")
                    reg.count("bytes", 3)
            threads = [threading.Thread(target=work) for _ in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert reg.snapshot()["counters"] == {"n": 8000, "bytes": 24000}
    # a thread started while a profiler records, which the profiler
    # itself does not see
    with profile(activities=[ProfilerActivity.CPU]):
        def worker():
            with reg.span("gstx:worker"):
                reg.count("worker")
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
    snap = reg.snapshot()
    assert snap["spans"]["gstx:worker"]["count"] == 1
    assert snap["counters"]["worker"] == 1


def test_cap_keeps_the_totals_and_counts_what_it_dropped():
    reg = profiling.Registry(max_spans=3)
    with reg.collecting():
        for _ in range(5):
            with reg.span("s"):
                pass
    assert len(reg.records()) == 3
    snap = reg.snapshot()
    assert snap["spans"]["s"]["count"] == 5
    assert snap["counters"]["dropped_spans"] == 2
    reg.reset()
    assert reg.snapshot() == {"spans": {}, "counters": {}}


def test_task_begun_before_collection_counts_from_its_start():
    reg = profiling.Registry()
    fetch = reg.task("fetch")
    fetch.__enter__()
    time.sleep(0.05)
    with reg.collecting():
        t0 = time.time_ns()
        time.sleep(0.01)
        fetch.__exit__(None, None, None)
    (name, start, end, parent, root, _), = reg.records()
    assert name == "fetch" and parent is None and root == 0
    assert abs(start - t0) < 5_000_000 and end - start < 40_000_000
    with reg.task("after"):
        pass  # ends outside collection: not recorded
    assert [r[0] for r in reg.records()] == ["fetch"]
