"""Bytes `segment_add_rows` needs (csrc/segment_sum.cu): every row of the
bases read once and every row of the outputs written once (its outputs
are new tensors, so each row is written), the int64 index and the
float32 values of every entry read once.  PERF.md's section 6 holds the
same count: 2.27 MB for one scan (720 entries, 40,000 rows, 7
channels), 145.0 MB for a B = 64 fleet step (46,080 entries, 2,560,000
rows)."""


def call_bytes(entries: int, rows: int, channels: int) -> int:
    return 2 * rows * channels * 4 + entries * (8 + channels * 4)


def step_bytes(fuser: dict, robots: int) -> int:
    """One fleet step's two calls: the scans' local maps (a square of
    twice sensor range + 3 cells a side) and the robots' maps, each the
    count, the point sums and the outer products (7 channels) of every
    point of every scan."""
    ndt = fuser["ndt"]
    res = ndt["resolution"]
    points = robots * ndt["max_points_per_scan"]
    local = round(2.0 * (ndt["sensor_range"] + 3.0 * res) / res)
    grid = round(ndt["size_y"] / res) * round(ndt["size_x"] / res)
    return (call_bytes(points, robots * local * local, 7)
            + call_bytes(points, robots * grid, 7))


# The names of its device kernels (csrc/segment_sum.cu).
KERNEL_RE = r"segment_add_rows_(bucket|row)_pass"
CALLS_PER_STEP = 2
