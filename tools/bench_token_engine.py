#!/usr/bin/env python3
"""Host time of the GOP token parse under each engine of the port
(alfalfa_tpu_torch/native/bitwork.py: the scalar parser over its OS
threads, and the AVX-512 engine), on this process pinned to all, 2 and 1
of its cores in turn, so that the "auto" rule (scalar above 2 cores, a
runtime calibration on 1-2) can be read against numbers.

    python tools/bench_token_engine.py [--ivf tests/fixtures/inter_1280x720_q48.ivf]
        [--gops 16] [--cores all,2,1] [--rounds 2]

BatchedGopDecoder(device="cpu").parse_frame_batch parses every frame of
the stream, repeated over G GOPs, as the main path's host half does; the
span parse.tok_start + parse.tok_join (the token parse the caller waits
for) and the whole parse are printed in ms a frame position, the engines
in turns (scalar, simd, simd, scalar per round).  Pinning uses
os.sched_setaffinity on this process alone; the parse threads follow the
pinned core count (ALFALFA_PARSE_THREADS).  One JSON line per core count.
The card is not used.  Exits 1 where the host has no AVX-512.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from alfalfa_tpu_torch.native import bitwork  # noqa: E402
from alfalfa_tpu_torch.parallel.gop import BatchedGopDecoder  # noqa: E402
from alfalfa_tpu_torch.util import tracing  # noqa: E402
from alfalfa_tpu_torch.util.ivf import IVFReader  # noqa: E402


def parse_ms(frames, width, height, G, engine):
    """(token-parse wait, whole parse) ms a frame position."""
    dec = BatchedGopDecoder(width, height, G, device="cpu",
                            token_engine=engine)
    tracing.enable(True)
    tracing.snapshot()
    t0 = time.perf_counter()
    for f in frames:
        dec.parse_frame_batch([f] * G)
    wall = time.perf_counter() - t0
    tracing.enable(False)
    spans = tracing.snapshot()
    tok = sum(spans[k]["seconds"] for k in ("parse.tok_start",
                                             "parse.tok_join") if k in spans)
    return tok * 1e3 / len(frames), wall * 1e3 / len(frames)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ivf", default="tests/fixtures/inter_1280x720_q48.ivf")
    ap.add_argument("--gops", type=int, default=16)
    ap.add_argument("--cores", default="all,2,1")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not bitwork.simd_supported():
        print("the host CPU has no AVX-512")
        return 1
    ivf = IVFReader(args.ivf)
    frames = [ivf.frame(i) for i in range(len(ivf))]
    cpus = sorted(os.sched_getaffinity(0))
    for spec in args.cores.split(","):
        n = len(cpus) if spec == "all" else int(spec)
        os.sched_setaffinity(0, cpus[:n])
        os.environ["ALFALFA_PARSE_THREADS"] = str(n)
        out = {"scalar": [], "simd": []}
        parse_ms(frames, ivf.width, ivf.height, args.gops, "scalar")  # warm
        parse_ms(frames, ivf.width, ivf.height, args.gops, "simd")
        for _ in range(args.rounds):
            for engine in ("scalar", "simd", "simd", "scalar"):
                out[engine].append(parse_ms(frames, ivf.width, ivf.height,
                                            args.gops, engine))
        print(json.dumps({
            "cores": n, "gops": args.gops, "frames": len(frames),
            "parse_threads": bitwork.parse_threads(args.gops),
            "stream": os.path.basename(args.ivf),
            "token_ms_per_frame_position": {
                k: [t for t, _ in v] for k, v in out.items()},
            "parse_ms_per_frame_position": {
                k: [w for _, w in v] for k, v in out.items()}}), flush=True)
    os.sched_setaffinity(0, cpus)
    return 0


if __name__ == "__main__":
    sys.exit(main())
