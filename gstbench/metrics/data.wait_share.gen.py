"""Share of the window spent waiting for the next prepared batch (the
benchmark's span around taking it from the CLI's host prefetch)."""


def read(r):
    c = r.window["counters"]
    return c["wait_s"] / r.window["seconds"] if "wait_s" in c else None
