"""``fused_ffn.wgmma_share.rank``, which reads the program's FFN counters,
fed known snapshots of ``gstx_torch.core.profiling``'s registry: the share
of launches that took the warp-specialised design; nothing from a window
with no launch, or from a program without that design."""

from types import SimpleNamespace

from gstbench import harness
from gstx_torch.core import profiling
from gstx_torch.kernels import ffn

NAME = "fused_ffn.wgmma_share.rank"


def test_wgmma_share_of_known_snapshots(monkeypatch):
    r = SimpleNamespace(window={"seconds": 40.0, "counters": {}})
    read = harness.reader(NAME)
    for counters, want in (
            # a disc batch: 1,800 text calls of 3,000
            ({"ffn.calls": 3000, "ffn.wgmma_calls": 1800}, 0.6),
            ({"ffn.calls": 1200, "ffn.wgmma_calls": 1200}, 1.0),
            ({"ffn.calls": 480}, 0.0),  # only the D = 1,024 calls
            ({"decode.steps": 10}, None),  # no FFN launch in the window
            ({}, None)):
        monkeypatch.setattr(profiling, "snapshot",
                            lambda c=counters: {"spans": {}, "counters": c})
        assert read(r) == want, counters
    # the parent of the design reads nothing, whatever it counted
    monkeypatch.delattr(ffn, "takes_wgmma")
    assert read(r) is None
