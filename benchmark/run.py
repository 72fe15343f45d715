#!/usr/bin/env python3
"""One run of one cell of the port's benchmark, on the CUDA card it is
started on:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is ``benchmark/workloads/<cell>.json``: the configuration it runs
(``benchmark/configs/<config>.json``), the driver that runs it
(``benchmark/drivers/<driver>.py``), the traffic parameters, and the
metrics it reports, each ``benchmark/metrics/<metric>.py``.  Adding a cell,
a configuration or a metric adds files; nothing here names one.

The run: set-up from the seed (inputs and program state made, every shape
the window uses warmed up), a window of ``--seconds``, and after it the
comparison with the plain reference that decides ``correct``.  With
``--trace 0`` the result holds the cell's end-to-end metrics, taken on the
host clock with tracing off; with ``--trace 1`` its per-layer metrics,
read from the program's spans and from ``torch.profiler``'s device trace
of the window, with the device's busy and window seconds and a breakdown.
The last line of standard output is the result, one JSON object; every
number the comparison checks is printed beside its limit as the last
lines of standard error and under the result's last key.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    return harness.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), t_start=T_START)


if __name__ == "__main__":
    sys.exit(main())
