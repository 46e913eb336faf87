"""Registration: device microseconds a step of the batched solve's
kernel (csrc/pair_fgh.cu), whose name KERNELS matches, in the traced
chunks (profiler); nothing where none ran."""

KERNELS = r"newton_solve_kernel"


def read(tr):
    t = tr.kernel_s(KERNELS)
    return None if t is None else 1e6 * t / tr.steps
