"""A run with the timed path broken underneath comes out not correct:
the look for a card is skipped and a small fleet is served on the CPU,
where the port runs its plain path, through the rest of a run, with
each fault the fleet cells can have planted in the fleet driver's call
(and a gather table whose refresh is left out).
The sound run beside them comes out correct.  (One chip, so there is no
exchange between chips to leave out.)"""

import dataclasses
import time

import pytest
import torch

from port_bench.harness import cell as cell_mod
from port_bench.harness import main, serve

ALTERED_M = 0.01     # an answer altered: every served position 1 cm off


def _unchanged(states, k):
    """A step that returns its state unchanged: the poses stand still."""
    base = getattr(states, "base", states)
    b = base.Tnow.shape[0]
    return (states, base.Tnow[:, None].expand(b, k, 3).clone(),
            torch.zeros(b, k))


def _stale(new, old):
    """The new states with the gather table left as it was before the
    chunk: the table's refresh left out."""
    if hasattr(new, "base"):
        return dataclasses.replace(new, base=_stale(new.base, old.base))
    return dataclasses.replace(new, packed=old.packed)


class Faulty(serve.Server):
    fault = None

    def chunk(self, states, c):
        if self.fault == "unchanged":
            return _unchanged(states, self.k)
        if self.fault == "half":
            # Half of the batch left out: the first half is served, the
            # rest keeps its state and its last pose.
            h = self.b // 2
            head = serve.tree_map(lambda x: x[:h], states)
            tail = serve.tree_map(lambda x: x[h:], states)
            s0 = (c * self.k) % self.loop
            new, traj, scores = self.driver(
                self.params, head,
                *(x[:h, s0:s0 + self.k] for x in self.inputs))
            _, t2, sc2 = _unchanged(tail, self.k)
            return (serve.tree_map(lambda a, b: torch.cat([a, b]), new, tail),
                    torch.cat([traj, t2]), torch.cat([scores, sc2]))
        new, traj, scores = super().chunk(states, c)
        if self.fault == "stale":
            return _stale(new, states), traj, scores
        states = new
        if self.fault == "altered":
            traj = traj + torch.tensor([ALTERED_M, 0.0, 0.0])
        return states, traj, scores


def _run(name, fault, robots=2):
    c = cell_mod.load(name)
    c.mix = dict(c.mix, robots=robots)
    cls = type("F", (Faulty,), {"fault": fault})
    return main.execute(c, 2 ** 31 + 11, 0.0, False, time.perf_counter(),
                        torch.device("cpu"), server_cls=cls)


@pytest.mark.parametrize("fault", [None, "unchanged", "half", "altered",
                                   "stale"])
def test_a_broken_step_is_not_correct(fault):
    out = _run("feat_fleet_b512_chunk4", fault)
    assert out["correct"] == (fault is None), out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


def test_a_stale_table_shows_in_the_table_gap():
    # The gather table is checked against the table built again from the
    # program's own statistics, not taken into the reference.
    sound = _run("ndt_fleet_b512_chunk4", None)["checks"]["table_gap"]
    stale = _run("ndt_fleet_b512_chunk4", "stale")["checks"]["table_gap"]
    assert stale["value"] > stale["limit"] >= sound["value"]
