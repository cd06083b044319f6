"""The window's matmul operations, counted from the shapes of the work it
did, over the window's length times the chips times the bf16 peak, in %."""

from gstbench import peaks


def read(r):
    flops = r.window["counters"].get("flops")
    if not flops:
        return None
    return 100.0 * flops / (r.window["seconds"] * r.cell.chips
                            * peaks.PEAK_BF16_FLOPS)
