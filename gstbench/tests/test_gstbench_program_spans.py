"""The per-layer metrics that read the program's own spans, each fed a
known snapshot of ``gstx_torch.core.profiling``'s registry; nothing from
an empty one, or from a program without the registry."""

from types import SimpleNamespace

from gstbench import harness
from gstx_torch.core import profiling

READERS = ("decode.step_ms.gen", "decode.step_share.gen",
           "data.queue_wait_share.gen", "data.loader_busy.rank")


def _span(count, total_s):
    return {"count": count, "total_s": total_s, "self_s": total_s / 2}


def test_readers_of_a_known_snapshot(monkeypatch):
    known = {"spans": {"gstx:decode.step": _span(400, 10.0),
                       "gstx:generate.wait": _span(5, 0.2),
                       "gstx:loader.fetch": _span(3, 6.0)},
             "counters": {"decode.steps": 400}}
    r = SimpleNamespace(window={"seconds": 20.0, "counters": {}})
    want = {"decode.step_ms.gen": 25.0, "decode.step_share.gen": 0.5,
            "data.queue_wait_share.gen": 0.01,
            "data.loader_busy.rank": 0.3}
    monkeypatch.setattr(profiling, "snapshot", lambda: known)
    for name in READERS:
        assert abs(harness.reader(name)(r) - want[name]) < 1e-12, name
    # collected, but no such span: no step to read; no wait, no loader work
    known["spans"] = {"gstx:engine.batch": _span(1, 1.0)}
    assert harness.reader("decode.step_ms.gen")(r) is None
    assert harness.reader("decode.step_share.gen")(r) is None
    assert harness.reader("data.queue_wait_share.gen")(r) == 0.0
    assert harness.reader("data.loader_busy.rank")(r) == 0.0
    # nothing collected (an untraced run)
    monkeypatch.setattr(profiling, "snapshot",
                        lambda: {"spans": {}, "counters": {}})
    for name in READERS:
        assert harness.reader(name)(r) is None, name
    # a program without the registry (the parent of the change that
    # brought it)
    monkeypatch.delattr(profiling, "snapshot")
    for name in READERS:
        assert harness.reader(name)(r) is None, name
