"""The decode step's mean host time, in ms: the program's span
``gstx:decode.step`` (one sampler iteration: the model's step, the
sampling and the end-of-sequence read) over its count, from the
program's registry, which collects while the traced window's profiler
records.  Nothing where the program has no registry or ran no step."""


def read(r):
    try:
        from gstx_torch.core.profiling import snapshot
    except ImportError:
        return None
    s = snapshot()["spans"].get("gstx:decode.step")
    if not s or not s["count"]:
        return None
    return 1000.0 * s["total_s"] / s["count"]
