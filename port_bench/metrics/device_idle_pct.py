"""Device: share of the traced window that no kernel, copy or memset
covers (the union of their intervals, profiler)."""


def read(tr):
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
