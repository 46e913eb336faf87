"""What the harness and its reference load: no module whose top-level
name is jax, jaxlib, flax or the JAX package (ndt_feature_graph_tpu),
compared whole, in a process that runs a cell on the CPU; and the
reference loads nothing of the port either."""

import json
import subprocess
import sys

from port_bench.harness.cell import ROOT

RUN = """
import json, sys, time
sys.path.insert(0, {root!r})
import torch
from port_bench.harness import cell, main
c = cell.load("ndt_fleet_b512_chunk4")
c.mix = dict(c.mix, robots=2)
out = main.execute(c, 2 ** 31 + 3, 0.0, False, time.perf_counter(),
                   torch.device("cpu"))
print(json.dumps([out["correct"], sorted({{m.split(".")[0]
                                           for m in sys.modules}})]))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import port_bench.harness.check, port_bench.reference.fuser
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

JAX = {"jax", "jaxlib", "flax", "ndt_feature_graph_tpu"}


def _top_level(code):
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    correct, names = _top_level(RUN)
    assert correct
    assert "ndt_feature_graph_tpu_torch" in names
    assert not JAX & set(names)


def test_the_reference_loads_nothing_of_the_program():
    names = set(_top_level(REFERENCE))
    assert not JAX & names
    assert "ndt_feature_graph_tpu_torch" not in names
