"""Stage timers, a throughput meter and a profiler region (port of
ndt_feature_graph_tpu/utils/timers.py).

Stage timers that wait for the device before they stop the clock, a
scans/s tracker, and a context manager that records a torch.profiler
trace (a Chrome trace file) for deep dives, where the reference uses
jax.profiler.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


def _leaves(tree, out):
    """Append every tensor of `tree` (a tensor, a dataclass of tensors,
    or a list, tuple or dict of them) to `out`."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    elif hasattr(tree, "__dataclass_fields__"):
        for name in tree.__dataclass_fields__:
            _leaves(getattr(tree, name), out)
    return out


def digest(*trees):
    """A scalar that depends on every tensor of `trees`: reading it back
    forces all the work that produced them (0 without tensors)."""
    return sum(x.to(torch.float32).sum() for x in _leaves(trees, []))


def force_readback(tree):
    """Force every tensor of `tree` by reading back one scalar digest of
    all of them, then synchronise the card if a tensor lies there.
    Returns the digest."""
    value = float(digest(tree))
    for dev in {x.device for x in _leaves(tree, [])
                if x.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return value


class StageTimers:
    """Accumulating named wall-clock timers (device-blocking)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                force_readback(block_on)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def mean_ms(self, name):
        c = self.counts[name]
        return 1e3 * self.totals[name] / c if c else 0.0

    def report(self):
        return "\n".join(
            f"{name:30s} {self.mean_ms(name):9.3f} ms avg "
            f"x{self.counts[name]}" for name in sorted(self.totals))


class ThroughputMeter:
    """scans/s tracker."""

    def __init__(self):
        self.n = 0
        self.t0 = time.perf_counter()

    def tick(self, k=1):
        self.n += k

    @property
    def per_sec(self):
        dt = time.perf_counter() - self.t0
        return self.n / dt if dt > 0 else 0.0


@contextlib.contextmanager
def device_trace(logdir):
    """torch.profiler region (host and, where there is a card, CUDA
    activity) that writes a Chrome trace, `logdir`/trace.json, when it
    ends (view it in chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
