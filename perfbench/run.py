"""Run one cell of the benchmark of the PyTorch port once, from the root
of a checkout, on the machine's first card:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It makes its inputs and weights from the seed, warms up the cell's shapes
(set-up, ``setup_s``: from the start of this process to the first timed
request), measures for ``--seconds``, checks the outputs against the plain
reference under ``perfbench/reference/``, and prints one JSON line last:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` a ``breakdown``, and ``checks`` (each compared number beside
its limit).  Exit codes: 0 done, 2 it cannot run here (no card, no port, an
unknown cell), 3 a forbidden module (JAX, the JAX package) was loaded.
"""
import time

T0 = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main.main(sys.argv[1:], T0))
