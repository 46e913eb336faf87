"""Fleet driver: device operations (kernels, copies, memsets) a step in
the traced chunks (profiler)."""


def read(tr):
    return len(tr.ops) / tr.steps
