"""Kernel: `occupancy_update`'s share of its HBM roofline in the traced chunks:
the bytes counts/occupancy_update.py counts for them, at 3.35 TB/s, over its
device time (profiler)."""

from port_bench.harness.trace import roofline_pct


def read(tr):
    return roofline_pct(tr, "occupancy_update")
