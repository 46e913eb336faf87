"""The traffic generator: one seed gives the same fleet, two seeds give
two, and within a fleet every robot has a world and a loop of its own
that closes on itself."""

import json

import pytest
import torch

from port_bench.harness.cell import BENCH
from port_bench.traffic import simulate

MIX = dict(json.loads((BENCH / "traffic" / "fleet_b512_chunk4.json")
                      .read_text()), robots=3)


def fleet(seed, hyp=4):
    return simulate.make_fleet(MIX, 720, 30.0, seed, hyp, "cpu")


def test_one_seed_repeats_exactly():
    a, b = fleet(2 ** 31 + 7), fleet(2 ** 31 + 7)
    for f in ("odom", "ranges", "hit", "gt", "ransac_u", "init_pose"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_seeds_and_robots_differ():
    a, b = fleet(11), fleet(12)
    assert not torch.equal(a.ranges, b.ranges)
    assert not torch.equal(a.gt, b.gt)
    for i in range(3):
        for j in range(i):
            assert not torch.equal(a.ranges[i], a.ranges[j])
            assert not torch.equal(a.gt[i], a.gt[j])


def test_the_patrol_closes_and_the_scans_hit():
    f = fleet(5)
    # Step s moves from scan s to scan s + 1: the odometry chains the
    # ground truth around the loop, back to scan 0.
    steps = f.gt.shape[1]
    assert steps == MIX["loop_steps"]
    assert torch.allclose(f.gt[:, -1], f.init_pose)
    step = torch.linalg.vector_norm(f.odom[..., :2], dim=-1)
    assert 0.05 < float(step.mean()) < 0.15
    assert float(f.hit.float().mean()) > 0.9
    assert float(f.ranges.max()) <= 30.0 + 0.1


@pytest.mark.parametrize("n", [0, 2])
def test_draws_only_where_asked(n):
    f = fleet(3, n)
    assert (f.ransac_u is None) == (n == 0)
