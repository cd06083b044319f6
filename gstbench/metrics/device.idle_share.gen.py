"""Share of the traced window in which no kernel, copy or set ran on the
card (the union of the device's activity in the profiler's trace)."""


def read(r):
    s = r.summary
    if not s or not s.get("window_s") or s["busy_s"] <= 0:
        return None
    return 1.0 - s["busy_s"] / s["window_s"]
