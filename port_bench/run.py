"""Run one cell of the port's benchmark on this machine's card:

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints one JSON line last on standard
output; see port_bench/harness/main.py."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# Every build and kernel cache at a fixed path inside the checkout.
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "port_bench" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "port_bench"
                                         / "torch_extensions")

from port_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main.main(sys.argv[1:], T_START))
