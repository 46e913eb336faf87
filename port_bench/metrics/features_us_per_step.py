"""Features: device microseconds a step of the feature kernels
(csrc/features.cu), whose names KERNELS matches, in the traced chunks
(profiler); nothing where none ran."""

KERNELS = r"features_(detect|describe|match)_kernel"


def read(tr):
    t = tr.kernel_s(KERNELS)
    return None if t is None else 1e6 * t / tr.steps
