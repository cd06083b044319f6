"""The loader's work beside the evaluator, in worker-seconds a second:
the total of the program's span ``gstx:loader.fetch`` (a worker building
and collating a batch, counted from the window's start when it began
before) over the traced window's length.  Nothing where the program has
no registry or collected nothing; 0 where no batch was built in the
window."""


def read(r):
    try:
        from gstx_torch.core.profiling import snapshot
    except ImportError:
        return None
    snap = snapshot()
    if not snap["spans"]:
        return None
    s = snap["spans"].get("gstx:loader.fetch")
    return (s["total_s"] if s else 0.0) / r.window["seconds"]
