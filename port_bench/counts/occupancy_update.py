"""Bytes `occupancy_update` needs (csrc/occupancy.cu): the log-odds of
every cell read once and written once, each point (two float32) and its
mask (one byte) read once, each sensor origin (two float32) read once.
PERF.md's section 6 holds the same count: 0.326 MB for one scan (720
points on 40,000 cells), 20.9 MB for a B = 64 fleet step."""


def call_bytes(points: int, cells: int, grids: int) -> int:
    return 2 * cells * 4 + points * (8 + 1) + grids * 8


def step_bytes(fuser: dict, robots: int) -> int:
    """One fleet step's call: every robot's map, every point of its
    scan."""
    ndt = fuser["ndt"]
    res = ndt["resolution"]
    grid = round(ndt["size_y"] / res) * round(ndt["size_x"] / res)
    return call_bytes(robots * ndt["max_points_per_scan"], robots * grid,
                      robots)


# The names of its device kernels (csrc/occupancy.cu).
KERNEL_RE = r"occupancy_(cluster|count|row)_kernel"
CALLS_PER_STEP = 1
