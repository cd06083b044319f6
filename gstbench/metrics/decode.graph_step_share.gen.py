"""Share of the traced window's decode steps that ran as one replay of a
captured CUDA graph: the program's counter ``decode.graph_replays`` over
``decode.steps``, from its registry, which collects while the traced
window's profiler records.  1.0 when every step was a replay.  Nothing
where the program has no registry, captures no decode step, or ran no
step."""


def read(r):
    try:
        from gstx_torch.core.profiling import snapshot
        from gstx_torch.decode.sampler import CapturedSampler  # noqa: F401
    except ImportError:
        return None
    c = snapshot()["counters"]
    steps = c.get("decode.steps")
    if not steps:
        return None
    return c.get("decode.graph_replays", 0) / steps
