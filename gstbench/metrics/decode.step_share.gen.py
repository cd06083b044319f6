"""Share of the traced window inside the program's decode steps: the
total of the span ``gstx:decode.step`` over the window's length, what a
faster decode step can take off a batch.  Nothing where the program has
no registry or ran no step."""


def read(r):
    try:
        from gstx_torch.core.profiling import snapshot
    except ImportError:
        return None
    s = snapshot()["spans"].get("gstx:decode.step")
    if not s or not s["count"]:
        return None
    return s["total_s"] / r.window["seconds"]
