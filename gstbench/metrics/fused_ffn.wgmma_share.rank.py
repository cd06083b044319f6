"""Share of the traced window's fused_ffn launches that ran the
warp-specialised design (a TMA ring feeding wgmma, at D = 768): the
program's counter ``ffn.wgmma_calls`` over ``ffn.calls``, from its
registry, which collects while the traced window's profiler records.
Nothing where the program lacks that design or launched no FFN kernel."""


def read(r):
    try:
        from gstx_torch.core.profiling import snapshot
        from gstx_torch.kernels.ffn import takes_wgmma  # noqa: F401
    except ImportError:
        return None
    c = snapshot()["counters"]
    calls = c.get("ffn.calls")
    if not calls:
        return None
    return c.get("ffn.wgmma_calls", 0) / calls
