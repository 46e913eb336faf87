"""Map update: device microseconds a step of its kernels
(csrc/segment_sum.cu, csrc/occupancy.cu), whose names KERNELS matches,
in the traced chunks (profiler); nothing where none ran."""

KERNELS = (r"segment_add_rows_(bucket|row)_pass"
           r"|occupancy_(cluster|count|row)_kernel")


def read(tr):
    t = tr.kernel_s(KERNELS)
    return None if t is None else 1e6 * t / tr.steps
