"""Share of the traced window the engine's thread waited on the host
prefetch's queue for its next prepared batch: the total of the program's
span ``gstx:generate.wait`` over the window's length.  Nothing where the
program has no registry or collected nothing; 0 where it collected but
never waited on the queue."""


def read(r):
    try:
        from gstx_torch.core.profiling import snapshot
    except ImportError:
        return None
    snap = snapshot()
    if not snap["spans"]:
        return None
    s = snap["spans"].get("gstx:generate.wait")
    return (s["total_s"] if s else 0.0) / r.window["seconds"]
