#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases
    python3 chip_smoke.py --quick    # env, build, kernels only (first look
                                     # at a changed kernel)

Builds the CUDA kernels and the native host parsers from the sources in
this checkout, and holds each kernel against its plain PyTorch version on
the card at the shapes its path gives it: K1 (wavefront_decode) and K2
(sixtap_mc) at 720p G=16 for the GOP decoder, K3 (predict_mb_tiles), K4
(intra_frame) and K5 (loop_filter) at 720p G=1 for the single-frame
decoder.  Then it drives both paths over tests/fixtures/inter_1280x720_q48.ivf
and checks each output's SHA-1 against tests/fixtures/manifest.json:

- main_path: 16 lockstep GOPs through BatchedGopDecoder.decode_stream;
- single_frame: the port's FilePlayer (Decoder.decode_frame), and a
  state file written after frame 3, loaded onto the card, decoding the rest.

Each phase prints JSON lines; any failure is a non-zero exit.  There is no
CPU path: without a CUDA device the script raises before it prints
anything.
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
from alfalfa_tpu_torch.decoder import Decoder, FilePlayer
from alfalfa_tpu_torch.decoder import reconstruct_torch as RT
from alfalfa_tpu_torch.native import bitwork
from alfalfa_tpu_torch.ops import intra_cuda, lf_cuda, sixtap, sixtap_cuda, \
    wavefront, wavefront_cuda
from alfalfa_tpu_torch.parallel import gop
from alfalfa_tpu_torch.state import serdes
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


def kernel_case(kernel, label, wrapper, plain, args, counts, bound_fn,
                reps=10, **extra):
    """Launch ``wrapper(*args)`` once and hold it against ``plain(*args)``,
    run once and timed; then time the wrapper.  ``counts`` reads the
    wrapper's kernel-launch count (as its C entry reported it)."""
    issued = counts()
    out = wrapper(*args)
    issued = counts() - issued
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    ref = plain(*args)
    b.record()
    torch.cuda.synchronize()
    plain_ms = a.elapsed_time(b)
    outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
    equal = all(torch.equal(x, y) for x, y in zip(outs, refs))
    err = max(max_abs_err(x, y) for x, y in zip(outs, refs))
    ms = time_ms(lambda: wrapper(*args), reps)
    b_ms, by = bound_fn(*args)
    case = dict(kernel=kernel, case=label, equal=equal, max_abs_err=err,
                kernel_ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                launches_per_call=issued, shape=list(outs[0].shape), **extra)
    say("kernels", **case)
    if not equal:
        raise SystemExit("%s disagrees with its plain version: %s"
                         % (kernel, label))
    return case


# ------------------------------------------------------------- K2, K3

def k2_bound(refs, ref_sel, sub_mv, S):
    """Least time for one MC call: motion vectors and selectors in, one
    plane's worth of reference pixels in, predictions out; two 6-tap passes
    (the first over S+5 rows) at 2 operations per tap."""
    n_mb = ref_sel.numel()
    px = n_mb * S * S
    bytes_ = sub_mv.numel() * 4 + ref_sel.numel() * 4 + 2 * px
    ops = n_mb * 2 * 6 * ((S + 5) * S + S * S)
    return bound(bytes_, ops)


def k2_case(label, *args):
    return kernel_case("sixtap_mc", label, sixtap_cuda.mc_tiles,
                       sixtap.mc_tiles_plain, args,
                       lambda: sixtap_cuda.kernel_launches, k2_bound, reps=20,
                       S=args[3])


def k3_case(label, *args):
    return kernel_case("predict_mb_tiles", label,
                       sixtap_cuda.predict_mb_tiles,
                       sixtap.predict_frame_plain, args,
                       lambda: sixtap_cuda.predict_kernel_launches, k2_bound,
                       reps=20, S=args[3])


def k2_synthetic(S, seed, g=2):
    """Seeded extreme motion vectors at 720p, G=g: SPLITMV blocks, windows
    fully outside the frame, full-pel, mixed full/sub-pel."""
    rng = np.random.default_rng(seed)
    R, C, n = 45, 80, S // 4
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


# --------------------------------------------------------- K1, K4, K5

def wave_bytes(n_mb):
    """Tiles (1 byte a pixel) and residuals (2) in, per-MB words (NP int16
    and 16 bmode bytes) in, planes out (1): K1's and K4's bytes."""
    px = n_mb * 384
    return px + 2 * px + n_mb * (wavefront_cuda.NP * 2 + 16) + px


def intra_ops(intra):
    """About 8 operations per predicted pixel of an intra macroblock."""
    return 8 * 384 * int(intra.sum().item())


def lf_ops(lfp):
    """About 50 operations per filtered edge position of a macroblock with
    a non-zero filter level, counted from this call's data."""
    level, skip_sb = lfp[0], lfp[5]
    _, R, C = level.shape
    on = level > 0
    has_col = (torch.arange(C, device=level.device) > 0)[None, None, :]
    has_row = (torch.arange(R, device=level.device) > 0)[None, :, None]
    edges = (on & has_col).sum() + (on & has_row).sum()
    inner = (on & ~skip_sb).sum()
    return 50 * int((edges * (16 + 2 * 8) + inner * (6 * 16 + 2 * 2 * 8)).item())


def k1_bound(*args):
    """Least time for one wavefront_decode call: K4's bytes, K4's and K5's
    operations."""
    intra, lfp = args[10], args[11]
    return bound(wave_bytes(intra.numel()), lf_ops(lfp) + intra_ops(intra))


def k4_bound(*args):
    return bound(wave_bytes(args[10].numel()), intra_ops(args[10]))


def k5_bound(y, u, v, lfp):
    """Planes in and out, per-MB words in; the filter's operations."""
    n_mb = lfp[0].numel()
    return bound(2 * n_mb * 384 + n_mb * wavefront_cuda.NP * 2, lf_ops(lfp))


def k1_case(label, args):
    return kernel_case("wavefront_decode", label,
                       wavefront_cuda.wavefront_decode,
                       wavefront.wavefront_decode_plain, args,
                       lambda: wavefront_cuda.kernel_launches, k1_bound,
                       intra_mbs=int(args[10].sum().item()),
                       filtered_mbs=int((args[11][0] > 0).sum().item()))


def k4_case(label, args):
    return kernel_case("intra_frame", label, intra_cuda.intra_frame,
                       wavefront.intra_frame_plain, args,
                       lambda: intra_cuda.kernel_launches, k4_bound,
                       intra_mbs=int(args[10].sum().item()))


def k5_case(label, args):
    return kernel_case("loop_filter", label, lf_cuda.loop_filter,
                       wavefront.loop_filter_plain, args,
                       lambda: lf_cuda.kernel_launches, k5_bound,
                       filtered_mbs=int((args[3][0] > 0).sum().item()))


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


def single_frame_kernel_inputs(payloads, width, height):
    """Decode frames 0 (key frame) and 1 (interframe) with the port's
    Decoder and keep the arguments each single-frame kernel wrapper was
    called with (recorded around the wrappers, which run as usual)."""
    kept = {}
    frame = [None]

    def record(name, fn):
        def wrapped(*args):
            kept.setdefault((name, frame[0]), []).append(args)
            return fn(*args)
        return wrapped

    originals = {n: getattr(RT, n) for n in
                 ("predict_mb_tiles", "intra_frame", "loop_filter")}
    for n, fn in originals.items():
        setattr(RT, n, record(n, fn))
    try:
        dec = Decoder(width, height, device=DEV)
        for f in (0, 1):
            frame[0] = f
            dec.decode_frame(payloads[f])
    finally:
        for n, fn in originals.items():
            setattr(RT, n, fn)
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


# wrapper calls and the kernel launches inside them, by kernel
COUNTS = {"sixtap_mc": (sixtap_cuda, "launches", "kernel_launches"),
          "wavefront_decode": (wavefront_cuda, "launches", "kernel_launches"),
          "predict_mb_tiles": (sixtap_cuda, "predict_launches",
                               "predict_kernel_launches"),
          "intra_frame": (intra_cuda, "launches", "kernel_launches"),
          "loop_filter": (lf_cuda, "launches", "kernel_launches")}


def zero_counts():
    for mod, calls, kernels in COUNTS.values():
        setattr(mod, calls, 0)
        setattr(mod, kernels, 0)


def read_counts():
    """({kernel: wrapper calls}, {kernel: kernel launches inside them})."""
    return ({k: getattr(m, c) for k, (m, c, _) in COUNTS.items()},
            {k: getattr(m, n) for k, (m, _, n) in COUNTS.items()})


def single_frame_decode(digest):
    """The 720p clip through the port's FilePlayer on the card; the SHA-1
    of the shown frames (if ``digest``)."""
    player = FilePlayer(CLIP, device=DEV)
    d = hashlib.sha1()
    for raster in player:
        if digest:
            d.update(raster.dump_bytes())
    torch.cuda.synchronize()
    return d.hexdigest()


def state_round_trip(payloads, width, height, k=3):
    """Decode frames 0..k, write a state file, load it onto the card and
    decode the rest with a new Decoder; the SHA-1 of all shown frames."""
    d = hashlib.sha1()
    dec = Decoder(width, height, device=DEV)
    for f, p in enumerate(payloads):
        if f == k + 1:
            state, refs = serdes.load_decoder(
                serdes.save_decoder(dec.state, dec.references), device=DEV)
            dec = Decoder(width, height, state=state, references=refs,
                          device=DEV)
        shown, raster = dec.decode_frame(p)
        if shown:
            d.update(raster.dump_bytes())
    return d.hexdigest()


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

    # the single-frame kernels on what the Decoder hands them at 720p
    sf = single_frame_kernel_inputs(payloads, ivf.width, ivf.height)
    mc = sf[("predict_mb_tiles", 1)]
    one = lambda refs, sel, mv, S: (refs[0], sel[0], mv[0], S)
    k3 = [k3_case("frame1 luma", *mc[0]),
          k3_case("frame1 chroma", *mc[1]),
          k3_case("synthetic extreme MVs luma", *one(*k2_synthetic(16, 16, 1))),
          k3_case("synthetic extreme MVs chroma", *one(*k2_synthetic(8, 24, 1)))]
    k4 = [k4_case("frame1 interframe", sf[("intra_frame", 1)][0]),
          k4_case("frame0 key frame", sf[("intra_frame", 0)][0])]
    k5 = [k5_case("frame1 interframe", sf[("loop_filter", 1)][0]),
          k5_case("frame0 key frame", sf[("loop_filter", 0)][0])]
    del sf, mc
    if quick:
        return

    # main path: counters to 0 just before, read just after
    zero_counts()
    got, _ = decode_all(payloads, ivf.width, ivf.height, digest=True)
    gop_calls, gop_kernels = read_counts()
    ok = [d == want for d in got]
    say("main_path", gops=G, frames=len(payloads), width=ivf.width,
        height=ivf.height, sha1_ok=ok, launches=gop_calls,
        kernel_launches=gop_kernels)
    if not all(ok):
        raise SystemExit("decoded frames differ from the manifest SHA-1")
    if gop_calls["sixtap_mc"] <= 0 or gop_calls["wavefront_decode"] <= 0:
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

    # single-frame path: counters to 0 just before, read just after
    zero_counts()
    sf_ok = single_frame_decode(digest=True) == want
    sf_calls, sf_kernels = read_counts()
    rt_ok = state_round_trip(payloads, ivf.width, ivf.height) == want
    sf_passes = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        single_frame_decode(digest=False)
        sf_passes.append(time.perf_counter() - t0)
    sf_best = min(sf_passes[1:])
    tracing.enable(True)
    tracing.snapshot()
    single_frame_decode(digest=False)
    tracing.enable(False)
    sf_split = {k: v["seconds"] * 1e3 / len(payloads)
                for k, v in tracing.snapshot().items()}
    single = dict(
        card=card, frames=len(payloads), sha1_ok=sf_ok,
        state_round_trip_sha1_ok=rt_ok, launches=sf_calls,
        kernel_launches=sf_kernels, frames_per_s=len(payloads) / sf_best,
        pass_s=sf_passes, ms_per_frame={
            "parse": sf_split.get("decode.parse"),
            "reconstruct": sf_split.get("decode.reconstruct")})
    say("single_frame", **single)
    say("single_frame_device_profile", **device_profile(
        lambda: single_frame_decode(digest=False), sf_best * 1e3))
    if not (sf_ok and rt_ok):
        raise SystemExit("single-frame decode differs from the manifest SHA-1")
    if min(sf_calls[k] for k in ("predict_mb_tiles", "intra_frame",
                                 "loop_filter")) <= 0:
        raise SystemExit("the single-frame path did not launch K3, K4 and K5")
    if sf_calls["sixtap_mc"] or sf_calls["wavefront_decode"]:
        raise SystemExit("the single-frame path launched a GOP kernel")

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
              "alfalfa_tpu/ops/sixtap_pallas.py:269",
              gop_calls["sixtap_mc"], cases[0], cases[:4] + small_cases[:2]),
        entry("wavefront_decode", "alfalfa_tpu_torch/csrc/wavefront.cu",
              "alfalfa_tpu/ops/wavefront_pm.py:432",
              gop_calls["wavefront_decode"], cases[4],
              cases[4:] + small_cases[2:]),
        entry("predict_mb_tiles", "alfalfa_tpu_torch/csrc/sixtap_mc.cu",
              "alfalfa_tpu/ops/sixtap_pallas.py:347",
              sf_calls["predict_mb_tiles"], k3[0], k3),
        entry("intra_frame", "alfalfa_tpu_torch/csrc/wavefront.cu",
              "alfalfa_tpu/ops/intra_pallas.py:346",
              sf_calls["intra_frame"], k4[0], k4),
        entry("loop_filter", "alfalfa_tpu_torch/csrc/wavefront.cu",
              "alfalfa_tpu/ops/lf_pallas.py:148",
              sf_calls["loop_filter"], k5[0], k5),
    ]}), flush=True)
    # again, so the end of the log has them
    say("throughput", **throughput)
    say("single_frame", **single)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
