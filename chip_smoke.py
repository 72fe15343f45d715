#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases
    python3 chip_smoke.py --quick    # env, build, kernels only (first look
                                     # at a changed kernel)

Builds the two CUDA kernels and the native host parsers from the sources in
this checkout, holds each kernel against its plain PyTorch version on the
card at the shapes the main path gives it (720p, G=16), then decodes
tests/fixtures/inter_1280x720_q48.ivf as 16 lockstep GOPs through
BatchedGopDecoder.decode_stream and checks every GOP's SHA-1 against
tests/fixtures/manifest.json.  Each phase prints one JSON line; any
failure is a non-zero exit.  There is no CPU path: without a CUDA device
the script raises before it prints anything.
"""
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    raise SystemExit("chip_smoke.py needs a CUDA device")

import numpy as np

from alfalfa_tpu_torch import _build
from alfalfa_tpu_torch.decoder import reconstruct_torch as RT
from alfalfa_tpu_torch.native import bitwork
from alfalfa_tpu_torch.ops import sixtap, sixtap_cuda, wavefront, wavefront_cuda
from alfalfa_tpu_torch.parallel import gop
from alfalfa_tpu_torch.state.decoder_state import Raster
from alfalfa_tpu_torch.util import tracing
from alfalfa_tpu_torch.util.ivf import IVFReader

REPO = os.path.dirname(os.path.abspath(__file__))
CLIP = os.path.join(REPO, "tests", "fixtures", "inter_1280x720_q48.ivf")
SMALL_CLIP = os.path.join(REPO, "tests", "fixtures", "inter_176x144_q96.ivf")
MANIFEST = os.path.join(REPO, "tests", "fixtures", "manifest.json")
G = 16
DEV = torch.device("cuda")

# Peaks of one H100 SXM (NVIDIA data sheet): device memory rate, and the
# float32 rate outside the tensor cores, the nearest published row for
# the int32 ALU work these kernels do.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


def say(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps, warmup=1):
    """Median time of fn() in ms by CUDA events, after warm-up runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_abs_err(a, b):
    return int((a.to(torch.int32) - b.to(torch.int32)).abs().max().item())


def bound(bytes_, ops):
    tb, to = bytes_ / PEAK_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S * 1e3
    return max(tb, to), "bytes" if tb >= to else "operations"


# ------------------------------------------------------------------ K2

def k2_bound(ref_sel, sub_mv, S):
    """Least time for one mc_tiles call: motion vectors and selectors in,
    one plane's worth of reference pixels in, predictions out; two 6-tap
    passes (the first over S+5 rows) at 2 operations per tap."""
    n_mb = ref_sel.numel()
    px = n_mb * S * S
    bytes_ = sub_mv.numel() * 4 + ref_sel.numel() * 4 + 2 * px
    ops = n_mb * 2 * 6 * ((S + 5) * S + S * S)
    return bound(bytes_, ops)


def k2_case(label, refs, ref_sel, sub_mv, S, plain_reps=3):
    issued = sixtap_cuda.kernel_launches
    out = sixtap_cuda.mc_tiles(refs, ref_sel, sub_mv, S)
    issued = sixtap_cuda.kernel_launches - issued   # as the C entry counted
    ref = sixtap.mc_tiles_plain(refs, ref_sel, sub_mv, S)
    torch.cuda.synchronize()
    equal = torch.equal(out, ref)
    err = max_abs_err(out, ref)
    ms = time_ms(lambda: sixtap_cuda.mc_tiles(refs, ref_sel, sub_mv, S), 20)
    plain_ms = time_ms(lambda: sixtap.mc_tiles_plain(refs, ref_sel, sub_mv, S),
                       plain_reps)
    b_ms, by = k2_bound(ref_sel, sub_mv, S)
    case = dict(kernel="sixtap_mc", case=label, S=S, equal=equal,
                max_abs_err=err, kernel_ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=by, launches_per_call=issued,
                shape=list(out.shape))
    say("kernels", **case)
    if not equal:
        raise SystemExit("sixtap_mc disagrees with its plain version: " + label)
    return case


def k2_synthetic(S, seed):
    """Seeded extreme motion vectors at 720p, G=2: SPLITMV blocks, windows
    fully outside the frame, full-pel, mixed full/sub-pel."""
    rng = np.random.default_rng(seed)
    g, R, C, n = 2, 45, 80, S // 4
    H, W = R * S, C * S
    refs = rng.integers(0, 256, (g, 3, H, W), dtype=np.uint8)
    sel = rng.integers(0, 4, (g, R, C)).astype(np.int32)
    base = rng.integers(-40, 40, (g, R, C, 1, 1, 2)).astype(np.int32)
    mv = np.broadcast_to(base, (g, R, C, n, n, 2)).copy()
    split = rng.random((g, R, C)) < 0.3
    mv[split] += rng.integers(-24, 24, (int(split.sum()), n, n, 2))
    mv[:, 0, 0] = -8 * (W + 64)              # fully outside, top-left
    mv[:, -1, -1] = 8 * (W + 64) + 3         # fully outside, bottom-right
    mv[:, 1, :] = (mv[:, 1, :] // 8) * 8     # full-pel row
    mv[:, 2, :, :, :, 0] &= ~7               # full-pel x, sub-pel y
    t = lambda a: torch.from_numpy(a).to(DEV)
    return t(refs), t(sel), t(mv), S


# ------------------------------------------------------------------ K1

def k1_bound(args):
    """Least time for one wavefront_decode call.  Bytes: tiles and
    residuals in, per-MB words in, planes out.  Operations, from this
    call's data: about 8 per predicted pixel of an intra macroblock and
    about 50 per filtered edge position of a macroblock with a non-zero
    filter level."""
    y, u, v, res_y, res_u, res_v, ymode, uvmode, bmode, nz, intra, lfp = args
    level, skip_sb = lfp[0], lfp[5]
    Gn, R, C = ymode.shape
    n_mb = Gn * R * C
    px = n_mb * 384
    bytes_ = px + 2 * px + n_mb * (wavefront_cuda.NP * 2 + 16) + px
    on = level > 0
    has_col = (torch.arange(C, device=level.device) > 0)[None, None, :]
    has_row = (torch.arange(R, device=level.device) > 0)[None, :, None]
    edges = (on & has_col).sum() + (on & has_row).sum()
    inner = (on & ~skip_sb).sum()
    positions = int((edges * (16 + 2 * 8) + inner * (6 * 16 + 2 * 2 * 8)).item())
    ops = 50 * positions + 8 * 384 * int(intra.sum().item())
    return bound(bytes_, ops)


def k1_case(label, args):
    issued = wavefront_cuda.kernel_launches
    out = wavefront_cuda.wavefront_decode(*args)
    issued = wavefront_cuda.kernel_launches - issued   # as the C entry counted
    t0 = time.perf_counter()
    ref = wavefront.wavefront_decode_plain(*args)
    torch.cuda.synchronize()
    plain_first_ms = (time.perf_counter() - t0) * 1e3
    equal = all(torch.equal(a, b) for a, b in zip(out, ref))
    err = max(max_abs_err(a, b) for a, b in zip(out, ref))
    ms = time_ms(lambda: wavefront_cuda.wavefront_decode(*args), 10)
    plain_ms = time_ms(lambda: wavefront.wavefront_decode_plain(*args), 1,
                       warmup=0)
    b_ms, by = k1_bound(args)
    Gn, R, C = args[6].shape
    case = dict(kernel="wavefront_decode", case=label, equal=equal,
                max_abs_err=err, kernel_ms=ms, plain_ms=plain_ms,
                plain_first_ms=plain_first_ms, bound_ms=b_ms, bound_by=by,
                launches_per_call=issued,
                intra_mbs=int(args[10].sum().item()),
                filtered_mbs=int((args[11][0] > 0).sum().item()),
                shape=[Gn, R * 16, C * 16])
    say("kernels", **case)
    if not equal:
        raise SystemExit("wavefront_decode disagrees with its plain version: "
                         + label)
    return case


def real_kernel_inputs(payloads, width, height, n_gops):
    """Walk frames 0 (key frame) and 1 (interframe) of a clip at n_gops
    GOPs with the decoder's own pieces and keep what it hands to each
    kernel."""
    dec = gop.BatchedGopDecoder(width, height, n_gops, device=DEV)
    kept = {}
    for f in (0, 1):
        key_frame, batch, _flags, _show = dec.parse_frame_batch(
            [payloads[f]] * n_gops)
        mega, spec_r, spec_c, _off = gop._pack_merged(batch)
        d = gop._unpack_upload(dec._upload(mega), spec_r + spec_c)
        inp, fls = dec._step_inputs(key_frame, d)
        if not key_frame:
            kept["mc_y"] = (dec.refs["y"], inp["ref_sel"], inp["sub_mv"], 16)
            kept["mc_u"] = (dec.refs["u"], inp["ref_sel"], inp["uv_mv"], 8)
        y, u, v, res_y, res_u, res_v, intra = RT._stage_ab(
            key_frame, inp["coeffs"], inp["qf"], inp["y2_coded"],
            inp["has_nonzero"], inp["ref_sel"], inp["sub_mv"], inp["uv_mv"],
            dec.refs)
        args = (y, u, v, res_y, res_u, res_v, inp["ymode"], inp["uvmode"],
                inp["bmode"], inp["has_nonzero"], intra, inp["lf_params"])
        kept["wave_key" if key_frame else "wave_inter"] = args
        planes = wavefront_cuda.wavefront_decode(*args)
        dec.refs = {p: gop.update_references(dec.refs[p], r, fls, key_frame)
                    for p, r in zip("yuv", planes)}
    torch.cuda.synchronize()
    return kept


# ----------------------------------------------------------- main path

def decode_all(payloads, width, height, digest):
    dec = gop.BatchedGopDecoder(width, height, G, device=DEV)
    digests = [hashlib.sha1() for _ in range(G)]
    last = None
    for (y, u, v), show in dec.decode_stream([p] * G for p in payloads):
        last = y
        if digest:
            ya, ua, va = y.cpu().numpy(), u.cpu().numpy(), v.cpu().numpy()
            for g in range(G):
                if show[g]:
                    digests[g].update(Raster(width, height, ya[g], ua[g],
                                             va[g]).dump_bytes())
    torch.cuda.synchronize()
    return [d.hexdigest() for d in digests], last


def device_profile(fn, wall_ms):
    """One pass under torch.profiler: device time by kernel (top 12) and
    the device's busy share of ``wall_ms``, the wall time of the same pass
    without the profiler (whose start-up would otherwise be counted).
    Where the profiler reports no device time, says so instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        return {"measured": False}
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return {"measured": True, "wall_ms": wall_ms, "device_busy_ms": busy,
            "device_busy_share": busy / wall_ms,
            "device_idle_share": 1 - busy / wall_ms,
            "top": [{"name": k[:80], "ms": ms, "calls": n}
                    for k, ms, n in rows[:12]]}


def main():
    quick = "--quick" in sys.argv[1:]
    card = smi()
    say("env", torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0], card=card,
        device=torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    logs = _build.build_all()
    for name in _build.KERNEL_SOURCES:
        _build.load_kernel(name)
    t_cuda = time.perf_counter() - t0
    t0 = time.perf_counter()
    bitwork._load()         # raises if the native parsers do not build:
    bitwork._load_mb()      # the Python token parser would hide the host cost
    say("build", cuda_kernels_s=t_cuda, native_parsers_s=time.perf_counter() - t0,
        ptxas={k: [l for l in v.splitlines() if "registers" in l or "error" in l]
               for k, v in logs.items()})

    ivf = IVFReader(CLIP)
    payloads = [ivf.frame(i) for i in range(len(ivf))]
    with open(MANIFEST) as fh:
        want = json.load(fh)[os.path.basename(CLIP)]["yuv_sha1"]

    # a small geometry with odd macroblock counts (9 x 11) and G=3 first
    small = IVFReader(SMALL_CLIP)
    kept = real_kernel_inputs([small.frame(0), small.frame(1)], small.width,
                              small.height, 3)
    small_cases = [
        k2_case("176x144 frame1 luma", *kept["mc_y"]),
        k2_case("176x144 frame1 chroma", *kept["mc_u"]),
        k1_case("176x144 frame1 interframe", kept["wave_inter"]),
        k1_case("176x144 frame0 key frame", kept["wave_key"]),
    ]

    kept = real_kernel_inputs(payloads, ivf.width, ivf.height, G)
    cases = [
        k2_case("frame1 luma", *kept["mc_y"]),
        k2_case("frame1 chroma", *kept["mc_u"]),
        k2_case("synthetic extreme MVs luma", *k2_synthetic(16, 16)),
        k2_case("synthetic extreme MVs chroma", *k2_synthetic(8, 24)),
        k1_case("frame1 interframe", kept["wave_inter"]),
        k1_case("frame0 key frame", kept["wave_key"]),
    ]
    del kept
    if quick:
        return

    # main path: counters to 0 just before, read just after
    sixtap_cuda.launches = 0
    wavefront_cuda.launches = 0
    got, _ = decode_all(payloads, ivf.width, ivf.height, digest=True)
    n_k2, n_k1 = sixtap_cuda.launches, wavefront_cuda.launches
    ok = [d == want for d in got]
    say("main_path", gops=G, frames=len(payloads), width=ivf.width,
        height=ivf.height, sha1_ok=ok, launches={"sixtap_mc": n_k2,
                                                 "wavefront_decode": n_k1})
    if not all(ok):
        raise SystemExit("decoded frames differ from the manifest SHA-1")
    if n_k2 <= 0 or n_k1 <= 0:
        raise SystemExit("the main path did not launch both kernels")

    # throughput: a few whole passes, device drained before each clock read
    passes = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode_all(payloads, ivf.width, ivf.height, digest=False)
        passes.append(time.perf_counter() - t0)
    best = min(passes[1:])
    # the split: one more pass with synchronising stage timers (no overlap)
    tracing.enable(True)
    tracing.snapshot()
    decode_all(payloads, ivf.width, ivf.height, digest=False)
    tracing.enable(False)
    split = {k: v["seconds"] * 1e3 / len(payloads)
             for k, v in tracing.snapshot().items()}
    throughput = dict(
        card=card, frames_per_s=G * len(payloads) / best,
        pass_s=passes, ms_per_frame_position={
            "host_parse": split.get("gop.parse"),
            "pack_and_h2d": split.get("gop.upload"),
            "device": split.get("gop.device")},
        parse_detail_ms={k: v for k, v in split.items() if k.startswith("parse.")})
    say("throughput", **throughput)

    say("device_profile", **device_profile(
        lambda: decode_all(payloads, ivf.width, ivf.height, digest=False),
        best * 1e3))

    def entry(name, source, replaces, launches, primary, all_cases):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(c["max_abs_err"] for c in all_cases),
                "ms": primary["kernel_ms"], "plain_ms": primary["plain_ms"],
                "bound_ms": primary["bound_ms"], "bound_by": primary["bound_by"],
                "library_ms": None, "measured_on": primary["case"],
                "cases": all_cases}

    print(json.dumps({"kernels": [
        entry("sixtap_mc", "alfalfa_tpu_torch/csrc/sixtap_mc.cu",
              "alfalfa_tpu/ops/sixtap_pallas.py:269", n_k2, cases[0],
              cases[:4] + small_cases[:2]),
        entry("wavefront_decode", "alfalfa_tpu_torch/csrc/wavefront.cu",
              "alfalfa_tpu/ops/wavefront_pm.py:432", n_k1, cases[4],
              cases[4:] + small_cases[2:]),
    ]}), flush=True)
    say("throughput", **throughput)     # again, so the end of the log has it
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
