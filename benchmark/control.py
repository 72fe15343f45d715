#!/usr/bin/env python3
"""The controls of a cell's comparison, on the card at the cell's size:

    python3 benchmark/control.py --workload <cell> --seed <n> [--seed <m> ...]
        [--control <name> ...] [--jobs <k>]

For each seed: the cell's set-up, then for each control a short window
with the control's fault planted in the program (drivers that name
faults in ``CONTROLS``), then the comparison with the plain reference.
The control "precision" puts the reference, computed with one of the
configuration's guarantees broken, in the program's place; "none" plants
nothing and reads the sound program's numbers, from which a limit's
lower reading comes.  Prints one JSON line a seed and control, with every
number read; every control other than "none" has to read
``"correct": false``.  ``--jobs`` runs the comparisons of a driver that
offers ``judge`` in that many processes beside the card's work.
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402


def _judge(bench, driver, args):
    """The comparison of a driver's ``judge``, in a worker process."""
    t0 = time.perf_counter()
    checks, numbers = harness.load_module("drivers", driver, bench).judge(*args)
    return checks, numbers, time.perf_counter() - t0


def _result(workload, seed, name, checks, numbers, seconds):
    return {"workload": workload, "seed": seed, "control": name,
            "correct": all(v <= lim for _, v, lim in checks),
            "seconds": seconds,
            "checks": {n: {"value": v, "limit": lim} for n, v, lim in checks},
            "numbers": numbers}


def control(workload, seed, device=None, bench=harness.BENCH, names=("precision",),
            pool=None):
    """The controls ``names`` of ``workload`` on ``seed``: a list of
    results, or with ``pool`` (an executor) of futures of them."""
    import torch
    wl, cfg = harness.cell(workload, bench)
    device = torch.device(device or "cuda")
    mod = harness.load_module("drivers", wl["driver"], bench)
    window = getattr(mod.Driver, "CONTROL_WINDOW_S", 0.0)
    driver = mod.Driver(cfg, wl, seed, device, window or 1.0)
    driver.setup()
    if not hasattr(driver, "planted"):
        # a driver whose only control is the reference in lower precision
        if window:
            driver.window(window)
        driver.release()
        t0 = time.perf_counter()
        checks = driver.control()
        return [_result(workload, seed, "precision", checks, {},
                        time.perf_counter() - t0)]
    out = []
    for name in names:
        with driver.planted(name):
            driver.window(window)
        args = driver.judged(None if name == "none" else name)
        if pool is None:
            out.append(_result(workload, seed, name, *_judge(bench, wl["driver"], args)))
        else:
            fut = pool.submit(_judge, bench, wl["driver"], args)
            out.append((workload, seed, name, fut))
    driver.release()
    return out


def main(argv=None):
    import argparse
    import concurrent.futures
    import multiprocessing
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--control", action="append")
    ap.add_argument("--jobs", type=int, default=0)
    args = ap.parse_args(argv)
    names = tuple(args.control or ("precision",))
    pool = None
    if args.jobs:
        pool = concurrent.futures.ProcessPoolExecutor(
            args.jobs, mp_context=multiprocessing.get_context("spawn"))
    pending = []
    try:
        for seed in args.seed:
            for r in control(args.workload, seed, names=names, pool=pool):
                if pool is None:
                    print(json.dumps(r), flush=True)
                else:
                    pending.append(r)
        for workload, seed, name, fut in pending:
            print(json.dumps(_result(workload, seed, name, *fut.result())), flush=True)
    finally:
        if pool is not None:
            pool.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
