"""Fleet driver: host milliseconds a step from the driver call's entry to
its return, before the readback waits, over the window's chunks (the
benchmark's own span, host clock)."""


def read(tr):
    return 1e3 * tr.host_s / tr.host_steps
