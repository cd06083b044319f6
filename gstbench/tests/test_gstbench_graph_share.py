"""``decode.graph_step_share.gen``, which reads the program's decode-step
counters, fed known snapshots of ``gstx_torch.core.profiling``'s registry:
the share of steps that were graph replays; nothing from a window with no
step, or from a program that captures no decode step."""

from types import SimpleNamespace

from gstbench import harness
from gstx_torch.core import profiling
from gstx_torch.decode import sampler

NAME = "decode.graph_step_share.gen"


def test_graph_step_share_of_known_snapshots(monkeypatch):
    r = SimpleNamespace(window={"seconds": 20.0, "counters": {}})
    read = harness.reader(NAME)
    for counters, want in (
            ({"decode.steps": 400, "decode.graph_replays": 400}, 1.0),
            ({"decode.steps": 400, "decode.graph_replays": 100}, 0.25),
            ({"decode.steps": 400}, 0.0),  # every step eager
            ({}, None)):                   # no step in the window
        monkeypatch.setattr(profiling, "snapshot",
                            lambda c=counters: {"spans": {}, "counters": c})
        assert read(r) == want, counters
    # a program without the captured step (the parent of the change that
    # brought it) reads nothing, whatever it counted
    monkeypatch.delattr(sampler, "CapturedSampler")
    assert read(r) is None
