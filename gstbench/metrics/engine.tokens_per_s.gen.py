"""Generated tokens (every non-PAD question and answer token of the
window's dialogs) per second of the window."""


def read(r):
    c = r.window["counters"]
    return c["tokens"] / r.window["seconds"] if c.get("tokens") else None
