#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases
    python3 chip_smoke.py --quick    # env, build, kernels only (first look
                                     # at a changed kernel)

Builds the CUDA kernels and the native host parsers from the sources in
this checkout (one nvcc per kernel source, all at once), and holds each
kernel against its plain PyTorch version on the card at the shapes its
path gives it: K1 (wavefront_decode) and K2 (sixtap_mc, through
mc_tiles: the three planes in one launch) at 720p G=16 for the GOP
decoder, K3 (the same kernel through predict_mb_tiles), K4 (intra_frame)
and K5 (loop_filter) at 720p G=1 for the single-frame decoder (K3 also on
the fast path's call: one LAST under two quantizers' vectors), K7
(encode_kf_frame, with H1 and H2 inside) at 720p and 176x144, one-pass and
two-pass, K8 (encode_inter_frame) at 720p and 176x144 in best, rt and
two-pass, as the fused 2-QP pair and on seeded extreme motion, and K9
(decide_inter_frame) and K10 (intra_fixup_frame) on what the fast path
hands them at 720p (one quantizer, the pair, a scene cut) and 176x144,
and the rebase's residue kernel (rebase_frame: K3's prediction, the inter
residues and the intra macroblocks in one row walk; no TPU counterpart,
XLA and a host loop there) on rebased frames 4 and 5's arguments, on
seeded SPLITMV macroblocks with extreme vectors at qi 0 and 127, a frame
of inter macroblocks, a frame of intra ones (the longest chain) and
seeded mixes at 176x144, on decoded frames of the fixtures; K5 also on
the encoders' 8-level loop-filter search call and at G=16 on the GOP
clip.  K1, K4, K5, K7, K8, K9, K10 and the residue kernel are persistent
(one launch a call, blocks walking rows behind progress flags): each of
their 720p cases runs 10 (K5, K7) or REPEATS (K1, K4, K8, K9, K10, the
residue kernel) times more, every run held to the plain output, since a
race between rows would show only now and then, and each runs once more
with more (row, frame or quantizer) blocks than the card holds at once.  Then it
drives the paths over
tests/fixtures/inter_1280x720_q48.ivf and checks each output's SHA-1:

- main_path: 16 lockstep GOPs through BatchedGopDecoder.decode_stream
  (against tests/fixtures/manifest.json); then the same with the AVX-512
  token engine (token_engine="simd", two or more parse threads), with
  gop.parse ms a frame position for the scalar parser and the engine in
  turns (main_path_simd; left out, on a line saying so, where the host
  CPU has no AVX-512);
- single_frame: the port's FilePlayer (Decoder.decode_frame), and a
  state file written after frame 3, loaded onto the card, decoding the rest
  (against the manifest);
- keyframe_encode: the port's Encoder encodes decoded frames 0 and 3 as key
  frames (KF_ENCODE_SHA1: the JAX package's encoder's frames), and the
  port's Decoder re-decodes every frame to the encoder's minihash;
- inter_encode: the port's Encoder encodes decoded frames 0-5, a key frame
  and then interframes, in best, rt, two-pass, minimum SSIM and the fused
  quantizer pair (INTER_ENCODE_SHA1: the JAX package's encoder's frames),
  and the port's Decoder re-decodes every frame to the encoder's minihash;
- fast_encode: the port's Encoder(quality="rt", fast=True) encodes a key
  frame and 17 fast interframes, and encode_interframe_fast_multiqp the
  Salsify pair over five frames (FAST_ENCODE_SHA1: the JAX package's fast
  path's frames); the Decoder re-decodes every frame to the encoder's
  minihash, and the stream stays within the serial rt encoder's RD band;
  then the host-patch variant with B_PRED (Encoder(fast_bpred=True)), the
  stream and the pair (FAST_PATCH_SHA1), under the same gates, with no K10
  launch in the stream (the pair runs K10 once a call and patches over
  it, as the JAX package's does), its patched macroblocks per frame and
  enc.fast_patch_host;
- rebase: ExCamera's xc-enc -I/-O and -r through the port's CLI: chunk 0
  (decoded frames 0-2) and an independent prediction chunk (frames 3-5)
  encoded at qi 48, then the prediction rebased onto chunk 0's state at
  key-frame weight 0.5 (REBASE_SHA1: the JAX package's frames); the
  port's Decoder re-decodes each rebased frame from chunk 0's state to
  the encoder's minihash; rebased frames/s with its spans, the residue
  updates' intra macroblocks and longest intra chains;
- xc_tools: ExCamera's chunk toolchain through the port's CLI on the
  rebase phase's files: xc terminate-chunk -O on chunk 0 (CLUSTER_SHA1's
  first frames), xc dump (the terminated state's bytes), xc diff and
  comp-states, xc enc -r onto the terminated state (CLUSTER_SHA1's
  rebased frames), xc merge and framesize, xc decode-bundle of the two
  chunks (the merged stream's y4m; CLUSTER_MINIHASH after each frame), xc
  ssim, zero-out-residues and dissect (XC_TOOLS_*: the JAX package's CLI's
  output), xc --timings and --profile (a trace naming K3's, K4's and K5's
  kernels); then the residue update's ms a frame (its upload, the
  residue kernel and the coefficient fetch), four turns;
- cluster: xc enc-parallel over frames 0-5 in chunks of 3, two worker
  processes on the card, then the serial rebase (CLUSTER_SHA1); FilePlayer
  decodes the stitched stream from scratch to CLUSTER_MINIHASH frame by
  frame; the wall time of each phase;
- salsify: the port's SalsifySender and SalsifyReceiver on loopback UDP in
  this process, both on the card (decoded frames 0-5 repeated to 30): s2
  lossless (every frame sent is received, the receiver lands on the
  sender's assumed state, its last raster equals the encoder's LAST), s2
  with fragment 0 of frame 2 dropped once (concealed: the receiver keeps
  displaying) and conventional mode over 12 frames; every payload sent,
  decoded by a fresh Decoder from its advertised source state, reaches its
  target minihash; encode ms p50/p95 beside Salsify's 33 ms design
  point, frame gaps, bytes, skips and the receiver's decode ms;
- mesh: parallel/gop.py's multi-device steps in this one process, on the
  visible cards and on a 4-shard mesh over cuda:0 (four ring hops):
  gop_decode_step on frames 1-4 against the single-frame Decoder's SHA-1s,
  gop_encode_step against one K7 call a chunk, gop_rebase_chain over
  rebase_chain_inputs_from_ivf (4 chunks of 2 frames) against the same
  chain run serially through the rebase's residue update; ms a step and
  a hop.

Each path runs with the launch counts set to 0 just before it and read
just after, and every K1 and six-tap call of the GOP path and every K3,
K4, K5, K7, K8, K9, K10 and residue-kernel call of the single-frame,
encode, rebase, xc tools, cluster, Salsify and mesh paths is checked to
be one kernel launch (`main_path`, `persistent_launches`); the last lines
are the `kernels` JSON line (one entry per kernel), the card's name and
power limit, and the result line.
Each phase prints JSON lines; any failure is a non-zero exit.  There is no
CPU path: without a CUDA device main() raises before it prints anything
(the module itself imports on a CPU host, for its constants).
"""
import hashlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from alfalfa_tpu_torch import _build
from alfalfa_tpu_torch.bitstream import tables as T
from alfalfa_tpu_torch.bitstream.header import QuantIndices
from alfalfa_tpu_torch.cli import xc
from alfalfa_tpu_torch.decoder import Decoder, FilePlayer
from alfalfa_tpu_torch.decoder import reconstruct_torch as RT
from alfalfa_tpu_torch.encoder import Encoder
from alfalfa_tpu_torch.encoder import encode_inter, encode_inter_fast
from alfalfa_tpu_torch.encoder import reencode as RB
from alfalfa_tpu_torch.encoder import reencode_device
from alfalfa_tpu_torch.encoder.costs import rd_multipliers
from alfalfa_tpu_torch.encoder.encode_intra import QUANT_KEYS
from alfalfa_tpu_torch.encoder.encoder import LF_CHUNK
from alfalfa_tpu_torch.encoder.trellis import token_costs_pm
from alfalfa_tpu_torch.input.frame_input import FrameInput
from alfalfa_tpu_torch.native import bitwork, enckernel
from alfalfa_tpu_torch.net import Packet
from alfalfa_tpu_torch.ops import enc_batch, enc_decide, enc_decide_cuda, \
    enc_inter, enc_inter_cuda, enc_intra, enc_intra_cuda, enc_intra_fixup, \
    enc_intra_fixup_cuda, enc_transforms, intra_cuda, lf_cuda, rebase, \
    rebase_cuda, sixtap, sixtap_cuda, transforms, trellis, wavefront, \
    wavefront_cuda
from alfalfa_tpu_torch.parallel import gop
from alfalfa_tpu_torch.parallel.cluster import parallel_encode
from alfalfa_tpu_torch.salsify import SalsifyReceiver, SalsifySender
from alfalfa_tpu_torch.state import serdes
from alfalfa_tpu_torch.state.decoder_state import Raster
from alfalfa_tpu_torch.util import tracing
from alfalfa_tpu_torch.util.ivf import IVFReader
from alfalfa_tpu_torch.util.ssim import ssim
from alfalfa_tpu_torch.util.y4m import Y4MWriter

REPO = os.path.dirname(os.path.abspath(__file__))
CLIP = os.path.join(REPO, "tests", "fixtures", "inter_1280x720_q48.ivf")
SMALL_CLIP = os.path.join(REPO, "tests", "fixtures", "inter_176x144_q96.ivf")
MANIFEST = os.path.join(REPO, "tests", "fixtures", "manifest.json")
G = 16
DEV = torch.device("cuda")

# The kernels line's ``library`` reason: no single PyTorch call computes
# these functions, so ``library_ms`` is null.
NO_LIBRARY = ("none: no single PyTorch call computes per-block VP8 six-tap "
              "motion compensation, intra prediction, the loop filter, "
              "the encoders' searches or the rebase's residue update")

# Peaks of one H100 SXM (NVIDIA data sheet): device memory rate, and the
# float32 rate outside the tensor cores, the nearest published row for
# the int32 ALU work these kernels do.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

# keyframe_encode: SHA-1 of each frame the JAX package's host encoder
# (alfalfa_tpu.encoder.Encoder(device_encode=False)) makes of frames 0 and 3
# of inter_1280x720_q48.ivf, decoded by the JAX package's FilePlayer (whose
# output meets the manifest), each encoded as a key frame: one encoder per
# mode, the two frames in sequence; "min_ssim_0.90_frame0" is
# encode_with_minimum_ssim(frame 0, 0.90) in a fresh one-pass encoder.
# Computed once on a CPU host; tests/test_torch_encoder.py recomputes them
# (-m slow).
KF_ENCODE_MODES = (("qi24", 24, False), ("qi64", 64, False),
                   ("qi32_two_pass", 32, True))
KF_MIN_SSIM = 0.90
KF_ENCODE_SHA1 = {
    "qi24_frame0": "94ad858b1bc14d666fa7a444707c2cb8ad80f639",
    "qi24_frame3": "052dd66de3962dd34541526cabe4850c07438f88",
    "qi64_frame0": "c98bd17b2adbc056b35145eff624079f29793d8a",
    "qi64_frame3": "d08095520d5e5c4a00977d9bf8bd0ba6e9de1c20",
    "qi32_two_pass_frame0": "e91eff4f07f3480b9ddf8c8b807aa5df02482e47",
    "qi32_two_pass_frame3": "a7e2013b606dd6aa8df0e91d058ba757105b927c",
    "min_ssim_0.90_frame0": "18a53d28c9c05a7e22a8df6822fb00b88cb1a1aa",
}


# rebase and cluster: SHA-1 of each frame the JAX package makes of decoded
# frames 0-5 of inter_1280x720_q48.ivf (its FilePlayer's, which meet the
# manifest).  REBASE_SHA1: its host encoder encodes chunk 0 (frames 0-2)
# and, independently, a prediction chunk (frames 3-5), both at qi 48 in
# best quality; its host reencode rebases the prediction against chunk 0's
# exit state at key-frame weight 0.5 (frame 3 a full inter encode, frames
# 4-5 the residue update, frame 5 refreshing every reference).
# CLUSTER_SHA1: its parallel_encode(workers=1) of frames 0-5 in chunks of
# 3 at qi 48, weight 0.5 (chunk 0 terminated, chunk 1 rebased onto it).
# REBASE_MINIHASH: the rebasing encoder's minihash after each frame;
# CLUSTER_MINIHASH: the JAX package's FilePlayer's after each stitched
# frame.  Computed once on a CPU host; tests/test_torch_rebase.py
# recomputes them (-m slow).
REBASE_FRAMES, REBASE_CHUNK, REBASE_QI, REBASE_KF_WEIGHT = 6, 3, 48, 0.5
REBASE_SHA1 = ["a37ddb36493787a95ea3a5b55949b5cd73c4b0f5",
               "aecff866280e2f2ca1768e13a59cb9ac5bc69c5e",
               "af7e727eb2489318a3c958ed2f1b5592e8b59d3d"]
CLUSTER_SHA1 = ["8fd62474aaaa54eb38fe34967290b0be424d977d",
                "6232b81cce006d449264108699189b28f439ef58",
                "822797c68c7a70bf3c761ead7a59a880b1b41efa",
                "a37ddb36493787a95ea3a5b55949b5cd73c4b0f5",
                "aecff866280e2f2ca1768e13a59cb9ac5bc69c5e",
                "af7e727eb2489318a3c958ed2f1b5592e8b59d3d"]
REBASE_MINIHASH = [4065873981, 621619213, 939088200]
CLUSTER_MINIHASH = [4122798039, 949739970, 555510815,
                    4065873981, 621619213, 939088200]


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
                reps=10, repeats=0, **extra):
    """Launch ``wrapper(*args)`` once and hold it against ``plain(*args)``,
    run once and timed; with ``repeats``, run the wrapper that many times
    more, each output held to the plain one; then time the wrapper.
    ``counts`` reads the wrapper's kernel-launch count (as its C entry
    reported it)."""
    issued = counts()
    out = wrapper(*args)
    issued = counts() - issued
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    ref = plain(*args)
    b.record()
    torch.cuda.synchronize()
    plain_ms = a.elapsed_time(b)
    tup = lambda x: x if isinstance(x, tuple) else (x,)
    outs, refs = tup(out), tup(ref)
    equal = all(torch.equal(x, y) for x, y in zip(outs, refs))
    err = max(max_abs_err(x, y) for x, y in zip(outs, refs))
    repeats_equal = 0
    for _ in range(repeats):
        again = tup(wrapper(*args))
        repeats_equal += all(torch.equal(x, y) for x, y in zip(again, refs))
        err = max(err, max(max_abs_err(x, y) for x, y in zip(again, refs)))
    ms = time_ms(lambda: wrapper(*args), reps)
    b_ms, by = bound_fn(*args)
    case = dict(kernel=kernel, case=label, equal=equal, max_abs_err=err,
                kernel_ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                launches_per_call=issued, shape=list(outs[0].shape), **extra)
    if repeats:
        case.update(repeats=repeats, repeats_equal=repeats_equal)
    say("kernels", **case)
    if not equal or repeats_equal != repeats:
        raise SystemExit("%s disagrees with its plain version: %s (%d of %d "
                         "repeats equal)" % (kernel, label, repeats_equal,
                                              repeats))
    return case


# ------------------------------------------------------------- K2, K3

def unique_bytes(t):
    """Bytes of ``t``'s storage that its elements cover once (an expanded
    view counts its broadcast axes once)."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n


def mc_bound(refs, ref_sel, sub_mv, uv_mv):
    """Least time for one call of the six-tap kernel (mc_tiles' or
    predict_mb_tiles' arguments): vectors and selectors in (each stored
    value once), one reference frame's pixels for each frame that has its
    own (a macroblock reads one slot), the three planes' predictions out;
    2 operations a tap of the passes this run's phases need (a 4x4 block's
    horizontal pass 9 rows x 4 pixels x 6 taps where x is sub-pel, its
    vertical pass 16 x 6 where y is)."""
    G, R, C = sub_mv.shape[:3]
    own = own_frames(refs, G)
    n_mb = G * R * C
    bytes_ = (unique_bytes(sub_mv) + unique_bytes(uv_mv)
              + (0 if ref_sel is None else ref_sel.numel() * 4)
              + (G if own else 1) * R * C * 384 + n_mb * 384)
    ops = 0
    for mv in (sub_mv, uv_mv, uv_mv):
        fx = (mv[..., 0] & 7) != 0
        fy = (mv[..., 1] & 7) != 0
        ops += int((fx.sum() * 9 * 4 * 6 + fy.sum() * 16 * 6).item()) * 2
    return bound(bytes_, ops)


def own_frames(refs, G):
    """Whether each of the G frames has its own references: mc_tiles'
    (G, 3, H, W) stacks, or predict_mb_tiles' slots holding G frames (not
    one plane, nor one frame at batch stride 0)."""
    first = refs["y"] if torch.is_tensor(refs["y"]) else refs["y"][0]
    return first.dim() == 4 or (first.dim() == 3 and G > 1
                                and first.stride(0) != 0)


def mc_extra(args):
    refs, ref_sel, sub_mv = args[:3]
    return dict(frames=sub_mv.shape[0], mbs=sub_mv[0, ..., 0, 0, 0].numel(),
                own_references=own_frames(refs, sub_mv.shape[0]),
                ref_sel=ref_sel is not None,
                vector_strides=list(sub_mv.stride()))


def k2_case(label, args):
    return kernel_case("sixtap_mc", label, sixtap_cuda.mc_tiles,
                       sixtap.mc_planes_plain, args,
                       lambda: sixtap_cuda.kernel_launches, mc_bound, reps=20,
                       **mc_extra(args))


def k3_case(label, args):
    return kernel_case("predict_mb_tiles", label,
                       sixtap_cuda.predict_mb_tiles, sixtap.mc_planes_plain,
                       args, lambda: sixtap_cuda.predict_kernel_launches,
                       mc_bound, reps=20, **mc_extra(args))


def mc_synthetic(seed, g=2):
    """Seeded extreme motion vectors at 720p, G=g, all three planes (the
    chroma vectors drawn apart from the luma ones): SPLITMV blocks, windows
    fully outside the frame, full-pel, mixed full/sub-pel; mc_tiles'
    arguments."""
    rng = np.random.default_rng(seed)
    R, C = 45, 80
    refs = {p: rng.integers(0, 256, (g, 3, R * S, C * S), dtype=np.uint8)
            for p, S in (("y", 16), ("u", 8), ("v", 8))}
    sel = rng.integers(0, 4, (g, R, C)).astype(np.int32)
    mvs = []
    for n, W in ((4, C * 16), (2, C * 8)):
        base = rng.integers(-40, 40, (g, R, C, 1, 1, 2)).astype(np.int32)
        mv = np.broadcast_to(base, (g, R, C, n, n, 2)).copy()
        split = rng.random((g, R, C)) < 0.3
        mv[split] += rng.integers(-24, 24, (int(split.sum()), n, n, 2))
        mv[:, 0, 0] = -8 * (W + 64)              # fully outside, top-left
        mv[:, -1, -1] = 8 * (W + 64) + 3         # fully outside, bottom-right
        mv[:, 1, :] = (mv[:, 1, :] // 8) * 8     # full-pel row
        mv[:, 2, :, :, :, 0] &= ~7               # full-pel x, sub-pel y
        mvs.append(mv)
    t = lambda a: torch.from_numpy(a).to(DEV)
    return {p: t(r) for p, r in refs.items()}, t(sel), t(mvs[0]), t(mvs[1])


def mc_single(refs, ref_sel, sub_mv, uv_mv):
    """mc_tiles' arguments of frame 0 as predict_mb_tiles takes a single
    frame's: three separate (H, W) planes a plane, G = 1."""
    return ({p: tuple(refs[p][0, k].clone() for k in range(3)) for p in "yuv"},
            ref_sel[:1], sub_mv[:1], uv_mv[:1])


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
    """Planes in (a frame broadcast over G, batch stride 0, read once) and
    out, per-MB words in; the filter's operations."""
    n_mb = lfp[0].numel()
    n_in = n_mb // y.shape[0] if y.stride(0) == 0 else n_mb
    return bound((n_in + n_mb) * 384 + n_mb * wavefront_cuda.NP * 2,
                 lf_ops(lfp))


def k1_case(label, args, repeats=0):
    return kernel_case("wavefront_decode", label,
                       wavefront_cuda.wavefront_decode,
                       wavefront.wavefront_decode_plain, args,
                       lambda: wavefront_cuda.kernel_launches, k1_bound,
                       repeats=repeats, frames=args[6].shape[0],
                       intra_mbs=int(args[10].sum().item()),
                       filtered_mbs=int((args[11][0] > 0).sum().item()))


def tiled(args, G):
    """wavefront_decode's (or intra_frame's) arguments ``args`` repeated
    frame by frame over G frames."""
    def rep(t):
        if isinstance(t, tuple):
            return tuple(rep(x) for x in t)
        n = -(-G // t.shape[0])
        return t.repeat((n,) + (1,) * (t.dim() - 1))[:G].contiguous()
    return tuple(rep(t) for t in args)


def k4_case(label, args, repeats=0):
    return kernel_case("intra_frame", label, intra_cuda.intra_frame,
                       wavefront.intra_frame_plain, args,
                       lambda: intra_cuda.kernel_launches, k4_bound,
                       repeats=repeats, frames=args[6].shape[0],
                       intra_mbs=int(args[10].sum().item()),
                       b_pred_mbs=int(((args[6] == wavefront.B_PRED)
                                       & args[10]).sum().item()))


def k5_case(label, args, repeats=0):
    return kernel_case("loop_filter", label, lf_cuda.loop_filter,
                       wavefront.loop_filter_plain, args,
                       lambda: lf_cuda.kernel_launches, k5_bound,
                       repeats=repeats, frames=args[3][0].shape[0],
                       broadcast_input=args[0].stride(0) == 0,
                       filtered_mbs=int((args[3][0] > 0).sum().item()))


def k5_search_inputs(raster, qi):
    """loop_filter's arguments as the encoder's loop-filter search hands
    them over (Encoder._filter_levels: the unfiltered reconstruction
    broadcast over LF_CHUNK levels) when a best-quality encoder on the card
    encodes the decoded ``raster`` as a key frame at ``qi``: its first
    call, recorded around the wrapper (which runs as usual)."""
    from alfalfa_tpu_torch.encoder import encoder as enc_mod
    seen = []
    saved = enc_mod.loop_filter

    def record(*a):
        seen.append(a)
        return saved(*a)

    enc_mod.loop_filter = record
    try:
        Encoder(raster.display_width, raster.display_height,
                device=DEV).encode_with_quantizer(raster.display(), qi,
                                                  key_frame=True)
    finally:
        enc_mod.loop_filter = saved
    torch.cuda.synchronize()
    return seen[0]


def k5_tiled(args, G):
    """``args`` (one frame's planes and limits) broadcast over G frames,
    the levels varied per frame (frame g at level + g, mod 64, where the
    macroblock is filtered)."""
    y, u, v, lfp = args
    lf = tuple(torch.cat([x[:1]] * G) for x in lfp)
    step = torch.arange(G, device=lf[0].device)[:, None, None]
    lf = (torch.where(lf[0] > 0, (lf[0] + step) % 64, 0),) + lf[1:]
    return tuple(t[:1].expand((G,) + t.shape[1:]) for t in (y, u, v)) + (lf,)


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
            kept["mc"] = (dec.refs, inp["ref_sel"], inp["sub_mv"],
                          inp["uv_mv"])
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


# ------------------------------------------------------------------ K7

# integer operations per macroblock of K7, counted from csrc/enc_intra.cu:
# the B_PRED search (10 modes x 16 pixels x 16 sub-blocks: edge gather,
# predict, difference, square, reduce), one transform chain of a 4x4 block
# (fDCT, quantize, dequantize, iDCT, add and clamp), the whole-mode and
# chroma searches, and one trellis block (16 positions x 2 levels x 2 next
# levels)
K7_OPS_BSEARCH = 16 * 10 * 16 * 12
K7_OPS_CHAIN = 400
K7_OPS_WHOLE_SEARCH = 4 * 256 * 8
K7_OPS_CHROMA_SEARCH = 4 * 128 * 6
K7_OPS_TRELLIS = 16 * 2 * 2 * 20


def k7_bound(modes, trellis):
    """Least time for one encode_kf_frame call on this frame: the original
    planes in, coefficients, modes and reconstruction out; the operations
    of every macroblock's searches and transform chains (the whole-mode
    chain only where whole mode won, the trellis only with token costs)."""
    R, C = modes.shape[:2]
    n = R * C
    whole = int((modes[..., 2] != 0).sum().item())
    bytes_ = n * (384 + 25 * 16 * 2 + enc_intra.MODE_WORDS + 384)
    blocks = n * (16 + 8) + whole * 17          # quantized 4x4 blocks
    ops = (n * (K7_OPS_BSEARCH + K7_OPS_WHOLE_SEARCH + K7_OPS_CHROMA_SEARCH)
           + blocks * K7_OPS_CHAIN + (blocks * K7_OPS_TRELLIS if trellis
                                       else 0))
    return bound(bytes_, ops)


def kf_args(raster, qi, token_costs=None):
    """encode_kf_frame's arguments for a decoded frame at y_ac_qi ``qi``."""
    q = QuantIndices(y_ac_qi=qi).quantizer()
    rm, dm = rd_multipliers(int(q["y_ac"]))
    return (raster.y, raster.u, raster.v, [int(q[k]) for k in QUANT_KEYS],
            rm, dm, token_costs)


def k7_case(label, args, repeats=0):
    seen = {}

    def wrapper(*a):
        out = enc_intra_cuda.encode_kf_frame(*a)
        seen["modes"] = out[1]
        return out

    R, C = args[0].shape[0] // 16, args[0].shape[1] // 16
    return kernel_case("encode_kf_frame", label, wrapper,
                       enc_intra.encode_kf_frame_plain, args,
                       lambda: enc_intra_cuda.kernel_launches,
                       lambda *a: k7_bound(seen["modes"], a[6] is not None),
                       repeats=repeats, two_pass=args[6] is not None,
                       mbs=R * C)


# ------------------------------------------------------------------ K8

# inter_encode: SHA-1 of each frame the JAX package's host encoder
# (alfalfa_tpu.encoder.Encoder(device_encode=False)) makes of decoded frames
# 0-5 of inter_1280x720_q48.ivf: per mode of INTER_ENCODE_MODES a new
# encoder encodes frame 0 as a key frame and frames 1-5 as interframes;
# "min_ssim_0.90" is encode_with_minimum_ssim on frames 0-2; "pair" is a
# key frame at qi 56 in a realtime encoder, then frame 1 at qi 40 and at
# qi 72 in two forks of it (the port encodes the pair in one
# encode_interframe_multiqp call).  Computed once on a CPU host;
# tests/test_torch_inter_encoder.py recomputes them (-m slow).
INTER_FRAMES = 6
INTER_ENCODE_MODES = (("best_qi48", 48, "best", False),
                      ("rt_qi48", 48, "rt", False),
                      ("best_qi32_two_pass", 32, "best", True))
INTER_MIN_SSIM, INTER_MIN_SSIM_FRAMES = 0.90, 3
INTER_PAIR_KEY_QI, INTER_PAIR_QIS = 56, (40, 72)
INTER_ENCODE_SHA1 = {
    "best_qi32_two_pass_frame0": "e91eff4f07f3480b9ddf8c8b807aa5df02482e47",
    "best_qi32_two_pass_frame1": "bf4ebe2a1e9dea045afc81c52e40742af96be333",
    "best_qi32_two_pass_frame2": "3f6e1ac73bf5f2774eab2a59d19486d554a87705",
    "best_qi32_two_pass_frame3": "41233a1e302279aee80977b770b5d7b5b95316e4",
    "best_qi32_two_pass_frame4": "ca91e95c5f8798aa812acabbac8996db6d9a1e3a",
    "best_qi32_two_pass_frame5": "01518d899687f8d65472c947de42188c6190b7bd",
    "best_qi48_frame0": "8fd62474aaaa54eb38fe34967290b0be424d977d",
    "best_qi48_frame1": "6232b81cce006d449264108699189b28f439ef58",
    "best_qi48_frame2": "b45b4a4c5a0bd17815974b737d26e8b0f519d05e",
    "best_qi48_frame3": "177e919bb4da1cf75ad39fe25c4a0c34e18c59aa",
    "best_qi48_frame4": "56cb50789f53aaa2cb5b20c1dd4b31052ce786fe",
    "best_qi48_frame5": "f5dda6c6cc2e26e3aa1dbc5cf4d453dbc3e69278",
    "min_ssim_0.90_frame0": "18a53d28c9c05a7e22a8df6822fb00b88cb1a1aa",
    "min_ssim_0.90_frame1": "0d907f5f53cf5df64ec5e3695c7d865c99e3e480",
    "min_ssim_0.90_frame2": "5af1ec87c7aae510df14154717ad36f393425c1e",
    "pair_key_qi56_frame0": "2443209548e97f850ac24a542efecf7a7c98facb",
    "pair_qi40_frame1": "eb1613220d36b599eae70599177564cf43ac1aca",
    "pair_qi72_frame1": "eafe8528ad42bb70eadb4bf04a86aac807dd98b9",
    "rt_qi48_frame0": "8fd62474aaaa54eb38fe34967290b0be424d977d",
    "rt_qi48_frame1": "d3a46439d0dc93b77eb27b45560966b6762951c1",
    "rt_qi48_frame2": "2b3575757a8c6825b6e884e6ddc0f34597475828",
    "rt_qi48_frame3": "206af14cf1859c4afa612c3bce0507ca76ed834e",
    "rt_qi48_frame4": "3fbd95385f586a6846b34f51d231413ee8f97084",
    "rt_qi48_frame5": "1cec8d82fd9bf6d4eb04813e14dea75b9238c30b",
}

# fast_encode: SHA-1 of each frame the JAX package's fast rt path
# (alfalfa_tpu.encoder.Encoder(quality="rt") with ALFALFA_FAST_INTER=1: the
# key frame through the host encoder, the interframes through
# encode_inter_fast) makes of decoded frames of inter_1280x720_q48.ivf: a
# key frame (frame 0) at qi 48, then frames FAST_ORDER at qi 48, 17 fast
# interframes whose jumps back to frame 0 are scene cuts and whose 17th
# re-climbs the loop filter by the 16-frame period; "fast_pair" is a key
# frame at qi 56, then frames 1-5 each at qi 40 and 72 in two forks of the
# qi 40 stream (the port encodes each pair in one
# encode_interframe_fast_multiqp call).  Computed once on a CPU host;
# tests/test_torch_fast_inter.py recomputes them (-m slow).
FAST_QI, FAST_ORDER = 48, (1, 2, 3, 4, 5) + (0, 1, 2, 3, 4, 5) * 2
FAST_PAIR_KEY_QI, FAST_PAIR_QIS, FAST_PAIR_FRAMES = 56, (40, 72), 5
FAST_ENCODE_SHA1 = {
    "fast_pair_key_qi56_frame0": "2443209548e97f850ac24a542efecf7a7c98facb",
    "fast_pair_qi40_frame1": "e8e8d11f2faff020379f8c7bf5326373aaf867bf",
    "fast_pair_qi40_frame2": "55e98e23c834d5eb94b00c0f2d641e42dfb21ad4",
    "fast_pair_qi40_frame3": "6028932ce5a6b2d2e752ed2ccbf24f1c7e27ed7d",
    "fast_pair_qi40_frame4": "f73bf1e6c4d3c35ac123fa6b31a525b20a55bfb2",
    "fast_pair_qi40_frame5": "48acee3ee753a27e466772826b9535dfde016281",
    "fast_pair_qi72_frame1": "8d834308c752c38ab698e5001dcfe1786fc98f56",
    "fast_pair_qi72_frame2": "042e588763a65ab9f6fefc1cd03771402e2f8230",
    "fast_pair_qi72_frame3": "de107f105a1449bc22a3d3b262256cefeae89c03",
    "fast_pair_qi72_frame4": "6eb01383b0d83c01bc6909ff148d5a5186ec8394",
    "fast_pair_qi72_frame5": "f1cc125c9d9b6e85c40ec83c7487c077e87dc2e8",
    "fast_qi48_00_frame0": "8fd62474aaaa54eb38fe34967290b0be424d977d",
    "fast_qi48_01_frame1": "b4614dfd8c7fbb8f6b8ff994361257e915a9b49e",
    "fast_qi48_02_frame2": "1c1e35bbf2878e4a0f094506a82367d3419c9960",
    "fast_qi48_03_frame3": "c00da5409626ac1d9421987c3972abcd1c476f78",
    "fast_qi48_04_frame4": "9aaa3a60b1017c221721a6a88f94788bfb64ee53",
    "fast_qi48_05_frame5": "98b7808dd08ada7e330eb44cd7701ddc637a6b28",
    "fast_qi48_06_frame0": "e29d5cc03343ab17186d43665494d71ccfae1869",
    "fast_qi48_07_frame1": "2ecf6ba1400940cdbfab34871257ad596fe55dbe",
    "fast_qi48_08_frame2": "0a9ecccbcf3067364ecc86227b742a58c1e6349b",
    "fast_qi48_09_frame3": "9c16cc6d7241367c41cf331718b585019b618448",
    "fast_qi48_10_frame4": "b42e6ec1e9439d542e6a37eb2121283f3cfbc809",
    "fast_qi48_11_frame5": "73c2016bc80d6ed7a531e85ac473d122c8e9be44",
    "fast_qi48_12_frame0": "d60fab93ca547ce1341f8d4ba4e4739c6e4004fe",
    "fast_qi48_13_frame1": "69604efa832c187a5653fb424ef021d00f01eb8a",
    "fast_qi48_14_frame2": "737a4d8c7ea399dacb28d81a10396a9781b96980",
    "fast_qi48_15_frame3": "cec94a9545046b811d3b23f030725e99351b23f3",
    "fast_qi48_16_frame4": "508c42e9860e7a08924e2d31a3ad40fc4f0a1fa5",
    "fast_qi48_17_frame5": "713ba0d6757d266efbaaad12509f4deed38dd9a3",
}


# fast_encode, the host-patch variant: SHA-1 of each frame the JAX
# package's fast path makes with ALFALFA_FAST_FIXUP=0 and
# ALFALFA_FAST_BPRED=1 (the intra macroblocks encoded by its host intra
# encoder, B_PRED tried), of the frames and quantizers of
# FAST_ENCODE_SHA1: "patch_bpred" a key frame and the 17 fast interframes
# of FAST_ORDER, "patch_bpred_pair" the pair over frames 1-5.  (Without
# B_PRED its frames are FAST_ENCODE_SHA1's: K10 is that whole-mode
# encode.)  Computed once on a CPU host; tests/test_torch_fast_patch.py
# recomputes them (-m slow).
FAST_PATCH_SHA1 = {
    "patch_bpred_pair_key_qi56_frame0": "2443209548e97f850ac24a542efecf7a7c98facb",
    "patch_bpred_pair_qi40_frame1": "c80ea2bbb227a7ac4842ee5aebda0741862d4c1c",
    "patch_bpred_pair_qi40_frame2": "c44bb4982538cafd62b1a752b5092106c1b6bca9",
    "patch_bpred_pair_qi40_frame3": "44749e8a147b2c6a7b513dfe2774ad672241d72c",
    "patch_bpred_pair_qi40_frame4": "94e522a1ad19ffec92da3565aa7a6ac8fc94a263",
    "patch_bpred_pair_qi40_frame5": "5e5dd2f882a5533b96291c1570c34886209d361a",
    "patch_bpred_pair_qi72_frame1": "a8b7bc9153637bf2cf0ef19b5762de91b11c69e2",
    "patch_bpred_pair_qi72_frame2": "ab57a70b210a899e17463f3dd0a616ed63228f32",
    "patch_bpred_pair_qi72_frame3": "391fd003537fda500de3ea887607ded26078b731",
    "patch_bpred_pair_qi72_frame4": "1a735f9e061060b55fe38652314e401448dc2195",
    "patch_bpred_pair_qi72_frame5": "b87e31d30bb8004b9bc6dc91ddec98a8189fb04e",
    "patch_bpred_qi48_00_frame0": "8fd62474aaaa54eb38fe34967290b0be424d977d",
    "patch_bpred_qi48_01_frame1": "1ea38e6ec7549a3e0498647e1b6bf05343a0e13e",
    "patch_bpred_qi48_02_frame2": "4bd4cba6127b8de224604e85d60d9ed248edd171",
    "patch_bpred_qi48_03_frame3": "b394ad016930d650ba411c9cc4dbee22f6854fdc",
    "patch_bpred_qi48_04_frame4": "e7eaebfddd1888cb265486836ab283ee188348f8",
    "patch_bpred_qi48_05_frame5": "753b15fe6c6f4424cc560d4cc71f35fc60a7d74c",
    "patch_bpred_qi48_06_frame0": "07f5bac4af38aa37e955e2a535c0b89617a48367",
    "patch_bpred_qi48_07_frame1": "6b30b97ee1069dced3d4ec12dc646148815a2e49",
    "patch_bpred_qi48_08_frame2": "c42c5874469afbbbc65c1f6ad15d967f158b9110",
    "patch_bpred_qi48_09_frame3": "81250acab9f6218c5ad561199fc8fcc5abe73f74",
    "patch_bpred_qi48_10_frame4": "0089307acf82e6c8d73093a32bb462b656f9e2b1",
    "patch_bpred_qi48_11_frame5": "2dac0f32183d143542bed929259165eec6244e5f",
    "patch_bpred_qi48_12_frame0": "b5ce18c28a56c4358bcec1db1013896bc9968106",
    "patch_bpred_qi48_13_frame1": "f487eb1bad6a8f86051cd4de01c8d3b9b7b92f2d",
    "patch_bpred_qi48_14_frame2": "6affeec8a813a0de67fe32926c38d9e9c55e1281",
    "patch_bpred_qi48_15_frame3": "900122c2e611c57725b84bba732c7b79a51f373a",
    "patch_bpred_qi48_16_frame4": "a23f7ab6161c1328509de734e4e802a0e7bdf0d6",
    "patch_bpred_qi48_17_frame5": "b0ea4c4213aa385fef04428d054d87c9a47dfc45",
}


def patch_labels(pair=False):
    """The FAST_PATCH_SHA1 keys of a host-patch run, in payload order."""
    if pair:
        return ["patch_bpred_pair_key_qi%d_frame0" % FAST_PAIR_KEY_QI] + [
            "patch_bpred_pair_qi%d_frame%d" % (q, k)
            for k in range(1, FAST_PAIR_FRAMES + 1) for q in FAST_PAIR_QIS]
    return ["patch_bpred_qi%d_%02d_frame%d" % (FAST_QI, i, k)
            for i, k in enumerate((0,) + FAST_ORDER)]


# the fast_encode phase's runs: (the host patch with B_PRED, the pair)
FAST_RUNS = {"fast": (False, False), "fast_pair": (False, True),
             "patch_bpred": (True, False), "patch_bpred_pair": (True, True)}


def run_digests(name):
    """The run's expected SHA-1 by label."""
    return FAST_PATCH_SHA1 if FAST_RUNS[name][0] else FAST_ENCODE_SHA1


def run_labels(name):
    """The expected-digest keys of a fast_encode run, in payload order."""
    bpred, pair = FAST_RUNS[name]
    return patch_labels(pair) if bpred else fast_labels(name)


def fast_labels(name):
    """The FAST_ENCODE_SHA1 keys of a run, in payload order."""
    if name == "fast_pair":
        return ["fast_pair_key_qi%d_frame0" % FAST_PAIR_KEY_QI] + [
            "fast_pair_qi%d_frame%d" % (q, k)
            for k in range(1, FAST_PAIR_FRAMES + 1) for q in FAST_PAIR_QIS]
    return ["fast_qi%d_%02d_frame%d" % (FAST_QI, i, k)
            for i, k in enumerate((0,) + FAST_ORDER)]


# integer operations K8's work needs, counted as mc_bound counts the same
# filter: 2 a six-tap tap, only the passes a vector's sub-pel phases need
# (the mode words count the taps of every diamond site and candidate
# scored); a SAD term 3 a pixel (difference, absolute value, sum), a
# variance term 4 (difference, two sums, square); each site's rate and
# decision 40; the intra screening (4 whole modes of 256 pixels at 8) and
# the census per macroblock
K8_OPS_SAD_SITE = 256 * 3 + 40
K8_OPS_VAR_CAND = 256 * 4
K8_OPS_MB = 4 * 256 * 8 + 200


def chroma_taps(cmx, cmy):
    """Six-tap taps the two 8x8 chroma predictions of a macroblock at
    eighth-pel vector (cmx, cmy) need (as enc_inter.luma_taps)."""
    fx, fy = (cmx & 7) != 0, (cmy & 7) != 0
    return 2 * 6 * 8 * (torch.where(fx, torch.where(fy, 13, 8), 0)
                        + torch.where(fy, 8, 0))


def inter_labels(name):
    """The INTER_ENCODE_SHA1 keys of a run, in payload order."""
    if name == "pair":
        return ["pair_key_qi%d_frame0" % INTER_PAIR_KEY_QI] + [
            "pair_qi%d_frame1" % q for q in INTER_PAIR_QIS]
    if name == "min_ssim":
        return ["min_ssim_%.2f_frame%d" % (INTER_MIN_SSIM, k)
                for k in range(INTER_MIN_SSIM_FRAMES)]
    return ["%s_frame%d" % (name, k) for k in range(INTER_FRAMES)]


def k8_bound(modes, Q, trellis):
    """Least time for one encode_inter_frame call on this frame: originals
    and LAST in, coefficients, mode words and reconstruction out per
    quantizer; the operations of the diamond sites and candidates this run
    scored (the mode words count them, and the six-tap taps their vectors
    need), the chroma predictions and the Y2 and chroma chains of inter
    macroblocks, the screening and census per macroblock, and K7's
    per-macroblock count for the intra ones."""
    R, C = modes.shape[1:3]
    n = R * C
    md = modes.reshape(-1, enc_inter.MODE_WORDS).to(torch.int64)
    is_inter = md[:, 2] != 0
    inter = int(is_inter.sum().item())
    sites = int(md[:, enc_inter.SITES].sum().item())
    cands = int(md[:, enc_inter.CANDS].sum().item())
    taps = int(md[:, enc_inter.TAPS].sum().item()) + int(
        chroma_taps(md[:, 6], md[:, 7])[is_inter].sum().item())
    intra = Q * n - inter
    bytes_ = 2 * n * 384 + Q * n * (25 * 16 * 2 + enc_inter.MODE_WORDS * 4
                                    + 384)
    blocks_intra = intra * (16 + 8 + 17)
    ops = (2 * taps + sites * K8_OPS_SAD_SITE + cands * K8_OPS_VAR_CAND
           + Q * n * K8_OPS_MB + inter * 25 * K7_OPS_CHAIN
           + intra * (K7_OPS_BSEARCH + K7_OPS_WHOLE_SEARCH
                      + K7_OPS_CHROMA_SEARCH)
           + blocks_intra * (K7_OPS_CHAIN + (K7_OPS_TRELLIS if trellis else 0)))
    return bound(bytes_, ops)


def k8_case(label, args, repeats=0):
    seen = {}

    def wrapper(*a):
        out = enc_inter_cuda.encode_inter_frame(*a)
        seen["modes"] = out[1]
        return out

    Q = args[6].shape[0]
    R, C = args[0].shape[0] // 16, args[0].shape[1] // 16
    case = kernel_case("encode_inter_frame", label, wrapper,
                       enc_inter.encode_inter_frame_plain, args,
                       lambda: enc_inter_cuda.kernel_launches,
                       lambda *a: k8_bound(seen["modes"], Q, a[9] is not None),
                       repeats=repeats, two_pass=args[9] is not None,
                       realtime=bool(args[8]), quantizers=Q, mbs=R * C)
    md = seen["modes"]
    newmv = md[..., 0] == enc_inter.NEWMV
    say("kernels", kernel="encode_inter_frame", case=label,
        inter_mbs=int((md[..., 2] != 0).sum().item()),
        newmv_mbs=int(newmv.sum().item()),
        diamond_sites=int(md[..., enc_inter.SITES].sum().item()),
        candidates=int(md[..., enc_inter.CANDS].sum().item()),
        luma_taps=int(md[..., enc_inter.TAPS].sum().item()),
        max_abs_newmv=int(md[..., 4:6].abs().amax(-1)[newmv].max().item())
        if bool(newmv.any()) else 0)
    return case


def k8_args(raster0, raster1, key_qi, qis, quality="best", two_pass=False):
    """encode_inter_frame's arguments for ``raster1`` (a decoded frame) at
    the quantizers ``qis``, after an encoder on the card has encoded
    ``raster0`` as a key frame at ``key_qi``."""
    e = Encoder(raster0.display_width, raster0.display_height,
                quality=quality, two_pass=two_pass, device=DEV)
    e.encode_with_quantizer(raster0.display(), key_qi, key_frame=True)
    return encode_inter.kernel_inputs(
        e, raster1.display(), [QuantIndices(y_ac_qi=q) for q in qis])


def extreme_motion_planes(seed, width, height, shift):
    """Seeded extreme motion: (LAST, original) as (y, u, v) uint8 planes.
    LAST is a gentle ramp under smooth ripples of seeded phases, the
    original the same content moved ``shift`` pixels up and to the left,
    plus noise.  The ramp leads the diamond search's SAD towards the shift
    from afar, the ripples make every other vector's residual costly;
    vectors near the frame's bottom and right edges point far outside
    it."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height + shift, 0:width + shift].astype(np.float64)
    ph = rng.uniform(0, 2 * np.pi, 3)
    k = max(1, (width + height + 2 * shift) // 180)
    tex = ((xx + yy) / k + 40 * np.sin(xx / 5.3 + ph[0]) * np.cos(yy / 4.1 + ph[1])
           + 25 * np.sin((xx - yy) / 9.7 + ph[2]) + 60)
    tex = np.clip(np.rint(tex), 0, 255)
    last = tex[:height, :width].astype(np.uint8)
    orig = np.clip(tex[shift:, shift:] + rng.integers(-2, 3, (height, width)),
                   0, 255).astype(np.uint8)
    sub = lambda p: (p, np.ascontiguousarray(p[::2, ::2]),
                     np.ascontiguousarray(p[1::2, 1::2]))
    return sub(last), sub(orig)


def extreme_encoder(seed, width, height, shift, **kw):
    """(Encoder on the card whose LAST is extreme_motion_planes' LAST, the
    original planes)."""
    last, orig = extreme_motion_planes(seed, width, height, shift)
    e = Encoder(width, height, device=DEV, **kw)
    e.references.last = Raster(width, height, *(
        torch.from_numpy(p).to(DEV) for p in last))
    return e, orig


def k8_extreme(seed, width=1280, height=720, shift=127, qis=(48,)):
    """encode_inter_frame's arguments for extreme_motion_planes (by default
    at 720p: the search walks out towards its +-1023 eighth-pel edge)."""
    e, orig = extreme_encoder(seed, width, height, shift)
    return encode_inter.kernel_inputs(
        e, orig, [QuantIndices(y_ac_qi=q) for q in qis])


# the persistent kernels' repeat check: runs of each 720p case
REPEATS = 20


def over_residency_rows(resident, Q):
    """Rows of a frame whose (row, quantizer) blocks outnumber the
    ``resident`` blocks the card holds at once by a quarter."""
    return -(-resident * 5 // 4) // Q


# ------------------------------------------------------------- K9, K10

# integer operations per macroblock of K9 beyond the diamond sites and
# candidates its decision words count (as K8's): the census, the mv_ref
# rates and the decision
K9_OPS_MB = 200


def k9_bound(md):
    """Least time for one decide_inter_frame call on this frame: original
    and LAST luma in, intra costs in and the four decision words the
    function yields (is_inter, mode, mvx, mvy) out per quantizer; the
    operations of the diamond sites and candidates this run scored (the
    words count them, and the six-tap taps their vectors need), the census
    and decision per macroblock."""
    Q, R, C = md.shape[:3]
    n = R * C
    w = md.reshape(-1, enc_decide.DECIDE_WORDS).to(torch.int64)
    sites = int(w[:, enc_decide.SITES].sum().item())
    cands = int(w[:, enc_decide.CANDS].sum().item())
    taps = int(w[:, enc_decide.TAPS].sum().item())
    bytes_ = 2 * n * 256 + Q * n * (4 + 4 * 4)
    ops = (2 * taps + sites * K8_OPS_SAD_SITE + cands * K8_OPS_VAR_CAND
           + Q * n * K9_OPS_MB)
    return bound(bytes_, ops)


def k10_bound(md):
    """Least time for one intra_fixup_frame call: the is_inter word of each
    macroblock, the originals of the macroblocks intra at some quantizer
    and the inter reconstruction in, coefficients, modes and the final
    reconstruction out per quantizer (an inter macroblock reads nothing
    else); for each intra macroblock K7's whole-mode and chroma searches
    and its 25 transform chains."""
    Q, R, C = md.shape[:3]
    n = R * C
    is_intra = md[..., 0] == 0
    intra = int(is_intra.sum().item())
    intra_any = int(is_intra.any(dim=0).sum().item())
    bytes_ = intra_any * 384 + Q * n * (4 + 2 * 384 + 25 * 16 * 2
                                        + enc_intra_fixup.FIXUP_WORDS * 4)
    ops = intra * (K7_OPS_WHOLE_SEARCH + K7_OPS_CHROMA_SEARCH
                   + 25 * K7_OPS_CHAIN)
    return bound(bytes_, ops)


def fast_kernel_inputs(key, frame, key_qi, qis):
    """K9's, K10's and K3's arguments as the fast path hands them over for the
    decoded ``frame`` at the quantizers ``qis``, after a fast rt encoder on
    the card has encoded ``key`` as a key frame at ``key_qi``."""
    e = Encoder(key.display_width, key.display_height, quality="rt",
                fast=True, device=DEV)
    e.encode_with_quantizer(key.display(), key_qi, key_frame=True)
    return recorded_fast_frame(e, frame.display(), qis)


def recorded_fast_frame(e, planes, qis):
    """K9's, K10's and K3's arguments as the fast rt encoder ``e`` hands
    them over for the (y, u, v) ``planes`` at the quantizers ``qis``: one
    fast_frame call with its three kernel wrappers recorded (they run as
    usual)."""
    args = encode_inter_fast.frame_inputs(
        e, planes, [QuantIndices(y_ac_qi=q) for q in qis])
    kept = {}
    saved = {n: getattr(encode_inter_fast, n)
             for n in ("decide_inter_frame", "intra_fixup_frame",
                       "predict_mb_tiles")}

    def record(name, fn):
        def wrapped(*a):
            kept[name] = a
            return fn(*a)
        return wrapped

    for n, fn in saved.items():
        setattr(encode_inter_fast, n, record(n, fn))
    try:
        encode_inter_fast.fast_frame(*args)
    finally:
        for n, fn in saved.items():
            setattr(encode_inter_fast, n, fn)
    torch.cuda.synchronize()
    return (kept["decide_inter_frame"], kept["intra_fixup_frame"],
            kept["predict_mb_tiles"])


def k9_extreme(seed, width, height, shift, qis):
    """decide_inter_frame's arguments as fast_frame hands them over for
    extreme_motion_planes at the quantizers ``qis``."""
    e, orig = extreme_encoder(seed, width, height, shift, quality="rt",
                              fast=True)
    oy, _, _, ly, _, _, scalars, tables, rd = encode_inter_fast.frame_inputs(
        e, orig, [QuantIndices(y_ac_qi=q) for q in qis])
    mbc, _ibc, mvc2p, pcost, sadcost, mvcost = tables
    oy_t = wavefront.tile(oy[None], 16)[0]
    icost = torch.stack([enc_batch.intra_screen_source(oy_t, mbc, rm, dm)
                         for rm, dm in rd])
    return oy, ly, scalars, icost, (mvc2p, pcost, sadcost, mvcost)


def k10_scene_cut(seed, width, height, qis):
    """intra_fixup_frame's arguments as fast_frame hands them over for a
    seeded scene cut at the quantizers ``qis``: LAST one
    extreme_motion_planes texture, the original another (seed + 1) upside
    down, so that most macroblocks go intra, many of them neighbours."""
    e, _ = extreme_encoder(seed, width, height, 8, quality="rt", fast=True)
    _, other = extreme_motion_planes(seed + 1, width, height, 8)
    return recorded_fast_frame(
        e, tuple(np.ascontiguousarray(p[::-1]) for p in other), qis)[1]


def k9_case(label, args, repeats=0):
    seen = {}

    def wrapper(*a):
        seen["md"] = enc_decide_cuda.decide_inter_frame(*a)
        return seen["md"]

    R, C = args[0].shape[0] // 16, args[0].shape[1] // 16
    case = kernel_case("decide_inter_frame", label, wrapper,
                       enc_decide.decide_inter_frame_plain, args,
                       lambda: enc_decide_cuda.kernel_launches,
                       lambda *a: k9_bound(seen["md"]), repeats=repeats,
                       quantizers=args[2].shape[0], mbs=R * C)
    md = seen["md"]
    say("kernels", kernel="decide_inter_frame", case=label,
        inter_mbs=int((md[..., 0] != 0).sum().item()),
        newmv_mbs=int((md[..., 1] == enc_inter.NEWMV).sum().item()),
        diamond_sites=int(md[..., enc_decide.SITES].sum().item()),
        candidates=int(md[..., enc_decide.CANDS].sum().item()),
        luma_taps=int(md[..., enc_decide.TAPS].sum().item()))
    return case


def k10_case(label, args, repeats=0):
    md = args[3]
    R, C = md.shape[1:3]
    return kernel_case("intra_fixup_frame", label,
                       enc_intra_fixup_cuda.intra_fixup_frame,
                       enc_intra_fixup.intra_fixup_frame_plain, args,
                       lambda: enc_intra_fixup_cuda.kernel_launches,
                       lambda *a: k10_bound(md), repeats=repeats,
                       quantizers=md.shape[0], mbs=R * C,
                       intra_mbs=int((md[..., 0] == 0).sum().item()))


def helper_plain_ms(blocks=3600 * 25, seed=7):
    """The plain versions of H1 and H2 alone, on the card, over the 4x4
    blocks one 720p key frame quantizes (seeded residuals, one batched
    call each; inside K7 the CUDA helpers run per block and have no time
    of their own): H1 = fdct, quantize, dequantize, iDCT; H2 =
    trellis_quantize under the default token costs."""
    rng = np.random.default_rng(seed)
    orig = torch.from_numpy(rng.integers(0, 256, (blocks, 16))).to(DEV)
    pred = torch.from_numpy(rng.integers(0, 256, (blocks, 16))).to(DEV)
    f = lambda x: torch.full((blocks,), x, dtype=torch.int32, device=DEV)
    tc = torch.from_numpy(token_costs_pm(T.DEFAULT_COEFF_PROBS)[0]).to(DEV)
    ctx = torch.zeros(blocks, dtype=torch.int64, device=DEV)
    co = enc_transforms.fdct(orig, pred)

    def h1():
        q = enc_transforms.quantize(enc_transforms.fdct(orig, pred), 20, 31)
        return transforms.idct(transforms.dequantize(q, f(20), f(31)))

    def h2():   # y_dc 20, y_ac 31 and their RD multipliers (26, 1)
        return trellis.trellis_quantize(co, 20, 31, tc, ctx, 0, 26, 1)

    return {"blocks": blocks, "h1_plain_ms": time_ms(h1, 5),
            "h2_plain_ms": time_ms(h2, 5)}


def decoded_frames(path, frames):
    """The port's FilePlayer on the card: {index: Raster} of the shown
    frames ``frames``."""
    out = {}
    for i, raster in enumerate(FilePlayer(path, device=DEV)):
        if i in frames:
            out[i] = raster
        if i >= max(frames):
            break
    torch.cuda.synchronize()
    return out


def kf_encode_runs(frames, width, height, modes=None, hashes=True):
    """The keyframe_encode phase's encodes: for each mode of
    KF_ENCODE_MODES (all by default, or those named in ``modes``; "min_ssim"
    for the search) a new Encoder on the card encodes frames 0 and 3 as key
    frames in sequence, or runs encode_with_minimum_ssim on frame 0.
    Returns [(label, [payload], [minihash after each], [loop-filter level
    of each])] (minihashes only if ``hashes``: reading one copies the
    references to the host)."""
    runs = []
    for name, qi, two_pass in KF_ENCODE_MODES + (("min_ssim", None, False),):
        if modes is not None and name not in modes:
            continue
        e = Encoder(width, height, two_pass=two_pass, device=DEV)
        if qi is None:
            name = "min_ssim_%.2f" % KF_MIN_SSIM
            pls = [e.encode_with_minimum_ssim(frames[0], KF_MIN_SSIM,
                                              key_frame=True)]
            mhs = [e.minihash() if hashes else None]
            lfs = [e.last_loop_filter_level]
        else:
            pls, mhs, lfs = [], [], []
            for k in (0, 3):
                pls.append(e.encode_with_quantizer(frames[k], qi,
                                                   key_frame=True))
                mhs.append(e.minihash() if hashes else None)
                lfs.append(e.last_loop_filter_level)
        runs.append((name, pls, mhs, lfs))
    torch.cuda.synchronize()
    return runs


def keyframe_encode_phase(card, width, height):
    """The keyframe_encode phase (see the module docstring); returns its
    result line."""
    rasters = decoded_frames(CLIP, (0, 3))
    frames = {k: r.display() for k, r in rasters.items()}
    per_call = 1        # K7 is persistent: one launch a call

    # the encode path: counters to 0 just before, read just after
    zero_counts()
    runs = kf_encode_runs(frames, width, height)
    calls, kernels = read_counts()
    sha_ok = {}
    for name, pls, _, _ in runs:
        for k, p in zip((0, 3), pls):
            key = "%s_frame%d" % (name, k)
            sha_ok[key] = hashlib.sha1(p).hexdigest() == KF_ENCODE_SHA1[key]
    # every frame re-decoded by the port's Decoder on the card
    decode_ok = []
    for name, pls, mhs, _ in runs:
        dec = Decoder(width, height, device=DEV)
        for p, mh in zip(pls, mhs):
            dec.decode_frame(p)
            decode_ok.append(dec.minihash() == mh)

    # speed per mode: the device drained before each clock read.  The
    # end-to-end rate counts frames delivered (payloads); the minimum-SSIM
    # search runs several trial encodes (K7 calls) per frame, so its ms per
    # K7 encode is a per-layer figure of its own
    modes = [m[0] for m in KF_ENCODE_MODES] + ["min_ssim"]
    speed = {}
    for mode in modes:
        passes = []
        for _ in range(2):
            before = enc_intra_cuda.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (run,) = kf_encode_runs(frames, width, height, [mode],
                                    hashes=False)
            passes.append(time.perf_counter() - t0)
            n_enc = enc_intra_cuda.launches - before
        n_kf = len(run[1])
        best = min(passes)
        tracing.enable(True)
        tracing.snapshot()
        kf_encode_runs(frames, width, height, [mode], hashes=False)
        tracing.enable(False)
        split = {k: v["seconds"] * 1e3 / n_kf
                 for k, v in tracing.snapshot().items() if k.startswith("enc.")}
        speed[mode] = {"keyframes_per_call": n_kf,
                       "k7_encodes_per_call": n_enc, "pass_s": passes,
                       "keyframes_per_s": n_kf / best,
                       "ms_per_keyframe": best * 1e3 / n_kf,
                       "ms_per_k7_encode": best * 1e3 / n_enc,
                       "traced_ms_per_keyframe": split}
    profile = device_profile(
        lambda: kf_encode_runs(frames, width, height, hashes=False))
    line = dict(card=card, frames=[0, 3], width=width, height=height,
                sha1_ok=sha_ok, decode_minihash_ok=decode_ok,
                launches=calls, kernel_launches=kernels,
                k7_kernel_launches_per_call=per_call,
                loop_filter_levels={r[0]: r[3] for r in runs}, speed=speed,
                device_profile=profile)
    say("keyframe_encode", **line)
    if set(sha_ok) != set(KF_ENCODE_SHA1) or not all(sha_ok.values()):
        raise SystemExit("keyframe payloads differ from KF_ENCODE_SHA1")
    if not all(decode_ok):
        raise SystemExit("the Decoder's minihash differs from the encoder's")
    if calls["encode_kf_frame"] <= 0 or calls["loop_filter"] <= 0:
        raise SystemExit("the encode path did not launch K7 and K5")
    if kernels["encode_kf_frame"] != calls["encode_kf_frame"] * per_call:
        raise SystemExit("K7 did not launch one persistent kernel per call")
    if any(calls[k] for k in ("sixtap_mc", "wavefront_decode",
                              "predict_mb_tiles", "intra_frame")):
        raise SystemExit("the encode path launched a decode kernel")
    return line


def sync_clock():
    torch.cuda.synchronize()
    return time.perf_counter()


def inter_encode_runs(frames, width, height, modes=None, hashes=True):
    """The inter_encode phase's encodes: per mode of INTER_ENCODE_MODES,
    "min_ssim" and "pair" (all by default, or those named in ``modes``) a
    new Encoder on the card, as INTER_ENCODE_SHA1 describes.  Returns
    [(name, [payload], [minihash after each], [loop-filter level of each],
    seconds of the interframes (device drained at both ends), interframes
    delivered)] (minihashes only if ``hashes``: reading one copies the
    references to the host)."""
    runs = []
    for name, qi, quality, two_pass in INTER_ENCODE_MODES + (
            ("min_ssim", None, "best", False), ("pair", None, "rt", False)):
        if modes is not None and name not in modes:
            continue
        e = Encoder(width, height, quality=quality, two_pass=two_pass,
                    device=DEV)
        pls, mhs, lfs = [], [], []

        def kept(payload, enc):
            pls.append(payload)
            mhs.append(enc.minihash() if hashes else None)
            lfs.append(enc.last_loop_filter_level)

        if name == "pair":
            kept(e.encode_with_quantizer(frames[0], INTER_PAIR_KEY_QI,
                                         key_frame=True), e)
            forks = [e.fork() for _ in INTER_PAIR_QIS]
            t0 = sync_clock()
            res = encode_inter.encode_interframe_multiqp(
                forks, frames[1],
                [QuantIndices(y_ac_qi=q) for q in INTER_PAIR_QIS])
            t = sync_clock() - t0
            for (payload, _), f in zip(res, forks):
                kept(payload, f)
        elif name == "min_ssim":
            kept(e.encode_with_minimum_ssim(frames[0], INTER_MIN_SSIM,
                                            key_frame=True), e)
            t0 = sync_clock()
            for k in range(1, INTER_MIN_SSIM_FRAMES):
                kept(e.encode_with_minimum_ssim(frames[k], INTER_MIN_SSIM), e)
            t = sync_clock() - t0
        else:
            kept(e.encode_with_quantizer(frames[0], qi, key_frame=True), e)
            t0 = sync_clock()
            for k in range(1, INTER_FRAMES):
                kept(e.encode_with_quantizer(frames[k], qi), e)
            t = sync_clock() - t0
        runs.append((name, pls, mhs, lfs, t, len(pls) - 1))
    torch.cuda.synchronize()
    return runs


INTER_SPANS = ("enc.inter_inputs", "enc.inter_kernel", "enc.inter_fetch",
               "enc.inter_host", "enc.if_lf_search", "enc.if_counts_join",
               "enc.if_serialize")


def inter_encode_phase(card, width, height):
    """The inter_encode phase (see the module docstring); returns its
    result line."""
    rasters = decoded_frames(CLIP, tuple(range(INTER_FRAMES)))
    frames = {k: r.display() for k, r in rasters.items()}
    per_call = 1        # K8 is persistent: one launch a call

    # the encode path: counters to 0 just before, read just after; K8's
    # plain version must not run on the card
    plain_calls = [0]
    plain = enc_inter_cuda.encode_inter_frame_plain

    def counted(*a):
        plain_calls[0] += 1
        return plain(*a)

    enc_inter_cuda.encode_inter_frame_plain = counted
    try:
        zero_counts()
        runs = inter_encode_runs(frames, width, height)
        calls, kernels = read_counts()
    finally:
        enc_inter_cuda.encode_inter_frame_plain = plain
    sha_ok = {}
    for name, pls, _, _, _, _ in runs:
        for key, p in zip(inter_labels(name), pls):
            sha_ok[key] = hashlib.sha1(p).hexdigest() == \
                INTER_ENCODE_SHA1.get(key)
    # every frame re-decoded by the port's Decoder on the card (the pair:
    # each of its frames by a copy of the decoder after the key frame)
    decode_ok = []
    for name, pls, mhs, _, _, _ in runs:
        dec = Decoder(width, height, device=DEV)
        for k, (p, mh) in enumerate(zip(pls, mhs)):
            d = dec.copy() if name == "pair" and k > 0 else dec
            d.decode_frame(p)
            decode_ok.append(d.minihash() == mh)

    # speed per mode: interframes delivered per second (the key frame not
    # counted; a minimum-SSIM interframe counts once however many K8
    # encodes its search runs), better of two passes; spans in ms per
    # interframe from one traced pass
    modes = [m[0] for m in INTER_ENCODE_MODES] + ["min_ssim", "pair"]
    speed = {}
    for mode in modes:
        passes, n_k8 = [], 0
        for _ in range(2):
            before = enc_inter_cuda.launches
            ((_, _, _, _, t, n_if),) = inter_encode_runs(
                frames, width, height, [mode], hashes=False)
            passes.append(t)
            n_k8 = enc_inter_cuda.launches - before
        best = min(passes)
        tracing.enable(True)
        tracing.snapshot()
        inter_encode_runs(frames, width, height, [mode], hashes=False)
        tracing.enable(False)
        spans = tracing.snapshot()
        speed[mode] = {"interframes_per_call": n_if,
                       "k8_calls_per_call": n_k8, "pass_s": passes,
                       "interframes_per_s": n_if / best,
                       "ms_per_interframe": best * 1e3 / n_if,
                       "traced_ms_per_interframe": {
                           k: spans[k]["seconds"] * 1e3 / n_if
                           for k in INTER_SPANS if k in spans}}
    profile = device_profile(
        lambda: inter_encode_runs(frames, width, height, hashes=False))
    line = dict(card=card, frames=list(range(INTER_FRAMES)), width=width,
                height=height, sha1_ok=sha_ok, decode_minihash_ok=decode_ok,
                launches=calls, kernel_launches=kernels,
                k8_kernel_launches_per_call=per_call,
                k8_plain_calls=plain_calls[0],
                loop_filter_levels={r[0]: r[3] for r in runs}, speed=speed,
                device_profile=profile)
    say("inter_encode", **line)
    if set(sha_ok) != set(INTER_ENCODE_SHA1) or not all(sha_ok.values()):
        raise SystemExit("interframe payloads differ from INTER_ENCODE_SHA1")
    if not all(decode_ok):
        raise SystemExit("the Decoder's minihash differs from the encoder's")
    if calls["encode_inter_frame"] <= 0 or calls["loop_filter"] <= 0:
        raise SystemExit("the encode path did not launch K8 and K5")
    if kernels["encode_inter_frame"] != calls["encode_inter_frame"] * per_call:
        raise SystemExit("K8 did not launch one persistent kernel per call")
    if plain_calls[0]:
        raise SystemExit("the encode path ran K8's plain version on the card")
    if any(calls[k] for k in ("sixtap_mc", "wavefront_decode",
                              "predict_mb_tiles", "intra_frame")):
        raise SystemExit("the encode path launched a decode kernel")
    return line


FAST_SPANS = ("enc.fast_inputs", "enc.fast_kernel", "enc.fast_fetch",
              "enc.fast_host", "enc.fast_lf_device", "enc.if_lf_search",
              "enc.if_counts_join", "enc.if_serialize")
# what the fast path's speed is printed beside (no claim): the serial rt
# interframe as PERF.md's interframe table first recorded it (NVIDIA H100
# 80GB HBM3, 700 W) and the Salsify sender's design point for a 720p frame
# (salsify-sender.cc:160-170)
RECORDED_SERIAL_RT_MS = 36.10
SALSIFY_MS = 33.0


def fast_encode_runs(frames, width, height, modes=("fast", "fast_pair"),
                     hashes=True, quality=False):
    """The fast_encode phase's encodes, the FAST_RUNS named in ``modes``,
    as FAST_ENCODE_SHA1 and FAST_PATCH_SHA1 describe.  Returns [(name,
    [payload], [minihash after each], [loop-filter level of each], [luma
    SSIM of LAST against the source after each], seconds of the
    interframes (device drained at both ends), interframes delivered,
    [host-patched macroblocks of each])] (minihashes only if ``hashes``,
    SSIM only if ``quality``)."""
    runs = []
    src = {k: torch.from_numpy(np.ascontiguousarray(f[0])).to(DEV)
           for k, f in frames.items()} if quality else None

    def kept(out, payload, enc, k):
        pls, mhs, lfs, ss, pm = out
        pls.append(payload)
        mhs.append(enc.minihash() if hashes else None)
        lfs.append(enc.last_loop_filter_level)
        ss.append(float(ssim(enc.references.last.y[:height, :width], src[k]))
                  if quality else None)
        pm.append(enc.patched_mbs if len(pls) > 1 else 0)

    for name in modes:
        bpred, pair = FAST_RUNS[name]
        e = Encoder(width, height, quality="rt", fast=True, fast_bpred=bpred,
                    device=DEV)
        out = ([], [], [], [], [])
        kept(out, e.encode_with_quantizer(
            frames[0], FAST_PAIR_KEY_QI if pair else FAST_QI,
            key_frame=True), e, 0)
        t0 = sync_clock()
        if not pair:
            for k in FAST_ORDER:
                kept(out, e.encode_with_quantizer(frames[k], FAST_QI), e, k)
            n_if = len(FAST_ORDER)
        else:
            for k in range(1, FAST_PAIR_FRAMES + 1):
                forks = [e.fork() for _ in FAST_PAIR_QIS]
                res = encode_inter_fast.encode_interframe_fast_multiqp(
                    forks, frames[k], [QuantIndices(y_ac_qi=q)
                                       for q in FAST_PAIR_QIS])
                for (payload, _), f in zip(res, forks):
                    kept(out, payload, f, k)
                e = forks[0]        # on with the first quantizer's stream
            n_if = FAST_PAIR_FRAMES * len(FAST_PAIR_QIS)
        t = sync_clock() - t0
        runs.append((name, *out[:4], t, n_if, out[4]))
    return runs


def fast_sha1_ok(runs):
    """{label: payload SHA-1 equals its recorded digest} over the runs."""
    return {key: hashlib.sha1(p).hexdigest() == run_digests(name).get(key)
            for name, pls, *_ in runs
            for key, p in zip(run_labels(name), pls)}


def fast_decode_ok(runs, width, height):
    """Every frame of the runs re-decoded by the port's Decoder on the card
    to its encoder's minihash (the pair: each of its frames by a copy of
    the decoder of the first stream)."""
    decode_ok = []
    for name, pls, mhs, *_ in runs:
        dec = Decoder(width, height, device=DEV)
        dec.decode_frame(pls[0])
        decode_ok.append(dec.minihash() == mhs[0])
        step = len(FAST_PAIR_QIS) if FAST_RUNS[name][1] else 1
        for i in range(1, len(pls), step):
            for j in range(step):
                d = dec.copy() if step > 1 else dec
                d.decode_frame(pls[i + j])
                decode_ok.append(d.minihash() == mhs[i + j])
            if step > 1:
                dec.decode_frame(pls[i])
    return decode_ok


def rd_parity(run, s_sizes, s_quals):
    """RD parity of a single-quantizer run against the serial rt encoder
    (tests/test_fast_inter.py's gate): total size at most 1.15x, mean SSIM
    at least the serial one minus 0.01.  Returns (numbers, met)."""
    sizes = [len(p) for p in run[1][1:]]
    quals = run[4][1:]
    parity = {"fast_bytes": sum(sizes), "serial_bytes": sum(s_sizes),
              "size_ratio": sum(sizes) / sum(s_sizes),
              "fast_mean_ssim": float(np.mean(quals)),
              "serial_mean_ssim": float(np.mean(s_quals))}
    return parity, bool(sum(sizes) <= 1.15 * sum(s_sizes)
                        and np.mean(quals) >= np.mean(s_quals) - 0.01)


PATCH_SPANS = FAST_SPANS + ("enc.fast_patch_host",)


def fast_patch_runs(frames, width, height, serial):
    """fast_encode's host-patch variant (Encoder(fast_bpred=True)): the
    stream and the pair against FAST_PATCH_SHA1, re-decoded, the stream
    held to the serial rt encoder's RD band (``serial``: its sizes and
    SSIMs); K10 must not launch in the stream, and once a call in the
    pair.  Then one traced pass of the stream for the spans.  Returns
    (result line, [failures])."""
    modes = ("patch_bpred", "patch_bpred_pair")
    zero_counts()
    runs = fast_encode_runs(frames, width, height, modes, quality=True)
    calls, kernels = read_counts()
    sha_ok = fast_sha1_ok(runs)
    decode_ok = fast_decode_ok(runs, width, height)
    parity = {r[0]: rd_parity(r, *serial) for r in runs
              if not FAST_RUNS[r[0]][1]}
    speed = {}
    for mode in modes[:1]:
        tracing.enable(True)
        tracing.snapshot()
        ((*_, t, n_if, _),) = fast_encode_runs(frames, width, height,
                                               [mode], hashes=False)
        tracing.enable(False)
        spans = tracing.snapshot()
        speed[mode] = {"traced_ms_per_interframe": t * 1e3 / n_if, **{
            k: spans[k]["seconds"] * 1e3 / n_if
            for k in PATCH_SPANS if k in spans}}
    line = dict(sha1_ok=sha_ok, decode_minihash_ok=decode_ok,
                rd_parity={k: v[0] for k, v in parity.items()},
                rd_parity_ok={k: v[1] for k, v in parity.items()},
                patched_mbs_per_frame={r[0]: r[7] for r in runs},
                ms_per_interframe={r[0]: r[5] * 1e3 / r[6] for r in runs},
                sizes={r[0]: [len(p) for p in r[1]] for r in runs},
                loop_filter_levels={r[0]: r[3] for r in runs},
                launches=calls, kernel_launches=kernels, spans=speed)
    n_calls = len(FAST_ORDER) + FAST_PAIR_FRAMES
    fails = []
    if set(sha_ok) != set(FAST_PATCH_SHA1) or not all(sha_ok.values()):
        fails.append("host-patch payloads differ from FAST_PATCH_SHA1")
    if not all(decode_ok):
        fails.append("a host-patch frame's minihash differs from the "
                     "Decoder's")
    if not all(v[1] for v in parity.values()):
        fails.append("the host patch left the serial rt encoder's RD band")
    if calls["intra_fixup_frame"] != FAST_PAIR_FRAMES \
            or calls["encode_inter_frame"]:
        fails.append("the host-patch variant launched K8, or K10 other "
                     "than once a pair call (%d)" % FAST_PAIR_FRAMES)
    if calls["decide_inter_frame"] != n_calls \
            or calls["predict_mb_tiles"] != n_calls:
        fails.append("K9 or K3 ran other than once per host-patch "
                     "interframe (%d)" % n_calls)
    if not sum(sum(r[7]) for r in runs):
        fails.append("the host-patch runs patched no macroblock")
    return line, fails


def serial_rt_reference(frames, width, height):
    """The serial rt encoder (K8) on the fast stream's frames and
    quantizer: (payload sizes, luma SSIM of LAST against the source after
    each interframe), the RD-parity baseline."""
    e = Encoder(width, height, quality="rt", device=DEV)
    e.encode_with_quantizer(frames[0], FAST_QI, key_frame=True)
    sizes, quals = [], []
    for k in FAST_ORDER:
        sizes.append(len(e.encode_with_quantizer(frames[k], FAST_QI)))
        quals.append(float(ssim(e.references.last.y[:height, :width],
                                torch.from_numpy(np.ascontiguousarray(
                                    frames[k][0])).to(DEV))))
    return sizes, quals


def fast_encode_phase(card, width, height, serial_rt_ms):
    """The fast_encode phase: the fast rt path at 720p through the port's
    Encoder(fast=True) and encode_interframe_fast_multiqp (see
    FAST_ENCODE_SHA1); returns its result line."""
    rasters = decoded_frames(CLIP, tuple(range(6)))
    frames = {k: r.display() for k, r in rasters.items()}
    # K9 and K10 are persistent: one launch a call
    per_call = {"decide_inter_frame": 1, "intra_fixup_frame": 1}

    # the fast path: counters to 0 just before, read just after; K9's and
    # K10's plain versions must not run on the card
    plain_calls = [0]
    names = {enc_decide_cuda: "decide_inter_frame_plain",
             enc_intra_fixup_cuda: "intra_fixup_frame_plain"}
    saved = {m: getattr(m, n) for m, n in names.items()}

    def counted(fn):
        def wrapped(*a):
            plain_calls[0] += 1
            return fn(*a)
        return wrapped

    for m, fn in saved.items():
        setattr(m, names[m], counted(fn))
    try:
        zero_counts()
        runs = fast_encode_runs(frames, width, height, quality=True)
        calls, kernels = read_counts()
    finally:
        for m, fn in saved.items():
            setattr(m, names[m], fn)
    sha_ok = fast_sha1_ok(runs)
    decode_ok = fast_decode_ok(runs, width, height)
    serial = serial_rt_reference(frames, width, height)
    s_sizes = serial[0]
    parity, parity_ok = rd_parity(runs[0], *serial)
    sizes = [len(p) for p in runs[0][1][1:]]

    # speed per mode: interframes delivered per second (the key frame not
    # counted; the pair delivers two per call), better of two passes;
    # spans in ms per interframe from one traced pass
    speed = {}
    for mode in ("fast", "fast_pair"):
        passes = []
        for _ in range(2):
            ((_, _, _, _, _, t, n_if, _),) = fast_encode_runs(
                frames, width, height, [mode], hashes=False)
            passes.append(t)
        best = min(passes)
        tracing.enable(True)
        tracing.snapshot()
        fast_encode_runs(frames, width, height, [mode], hashes=False)
        tracing.enable(False)
        spans = tracing.snapshot()
        speed[mode] = {"interframes_per_call": n_if, "pass_s": passes,
                       "interframes_per_s": n_if / best,
                       "ms_per_interframe": best * 1e3 / n_if,
                       "traced_ms_per_interframe": {
                           k: spans[k]["seconds"] * 1e3 / n_if
                           for k in FAST_SPANS if k in spans}}
    profile = device_profile(
        lambda: fast_encode_runs(frames, width, height, ["fast"],
                                 hashes=False))
    line = dict(card=card, frames=[0] + list(FAST_ORDER), width=width,
                height=height, sha1_ok=sha_ok, decode_minihash_ok=decode_ok,
                rd_parity=parity, rd_parity_ok=bool(parity_ok),
                serial_rt_sizes=s_sizes, fast_sizes=sizes,
                launches=calls, kernel_launches=kernels,
                kernel_launches_per_call=per_call,
                plain_calls=plain_calls[0],
                loop_filter_levels={r[0]: r[3] for r in runs}, speed=speed,
                beside={"serial_rt_ms_this_run": serial_rt_ms,
                        "serial_rt_ms_recorded": RECORDED_SERIAL_RT_MS,
                        "salsify_design_point_ms": SALSIFY_MS},
                device_profile=profile)
    line["host_patch"], patch_fails = fast_patch_runs(frames, width, height,
                                                      serial)
    say("fast_encode", **line)
    if patch_fails:
        raise SystemExit("; ".join(patch_fails))
    n_calls = len(FAST_ORDER) + FAST_PAIR_FRAMES
    if set(sha_ok) != set(FAST_ENCODE_SHA1) or not all(sha_ok.values()):
        raise SystemExit("fast payloads differ from FAST_ENCODE_SHA1")
    if not all(decode_ok):
        raise SystemExit("the Decoder's minihash differs from the encoder's")
    if not parity_ok:
        raise SystemExit("the fast path left the serial rt encoder's RD band")
    for k in ("decide_inter_frame", "intra_fixup_frame"):
        if calls[k] != n_calls:
            raise SystemExit("%s ran %d times, not once per fast interframe "
                             "(%d)" % (k, calls[k], n_calls))
        if kernels[k] != calls[k] * per_call[k]:
            raise SystemExit("%s did not launch %d kernels per call"
                             % (k, per_call[k]))
    if plain_calls[0]:
        raise SystemExit("the fast path ran a plain version on the card")
    if calls["encode_inter_frame"] or calls["loop_filter"] <= 0:
        raise SystemExit("the fast path launched K8, or not K5")
    if calls["predict_mb_tiles"] != n_calls:
        raise SystemExit("K3 ran %d times, not once per fast interframe (%d)"
                         % (calls["predict_mb_tiles"], n_calls))
    if any(calls[k] for k in ("sixtap_mc", "wavefront_decode",
                              "intra_frame")):
        raise SystemExit("the fast path launched a decode kernel")
    return line


# --------------------------------------------- the rebase and the cluster

def residue_call(fn):
    """``fn`` (the residue wrapper or its plain version) on copies of the
    reconstruction planes; returns (output words, y, u, v)."""
    def call(orig, refs, words, quant, recon):
        out = [p.clone() for p in recon]
        return (fn(orig, refs, words, quant, out),) + tuple(out)
    return call


# integer operations of the residue update: about 500 a 4x4 block (the
# forward DCT's two passes, quantization, dequantization, the inverse
# DCT's two passes, the add and clamp), 400 a macroblock for Y2's forward
# and inverse WHT and its quantization, and an intra macroblock's
# prediction (4 a pixel: edges, the mode's average, the clamp)
RESIDUE_OPS_BLOCK, RESIDUE_OPS_Y2, RESIDUE_OPS_PRED = 500, 400, 384 * 4


def intra_chain(ref, ymode):
    """The longest chain of intra macroblocks of a frame's (R, C)
    references and luma modes (host numpy), each after its intra
    neighbours left, above-left, above and (B_PRED) above-right: the
    macroblocks the residue kernel must do one after another."""
    intra = ref == T.CURRENT_FRAME
    bpred = ymode == T.B_PRED
    R, C = intra.shape
    depth = np.zeros((R + 1, C + 2), np.int64)     # padded: row -1, cols
    for r in range(R):
        for c in range(C):
            if intra[r, c]:
                up = depth[r, c:c + 2 + bool(bpred[r, c])].max()
                depth[r + 1, c + 1] = 1 + max(up, depth[r + 1, c])
    return int(depth.max())


def rebase_bound(orig, refs, words, quant, recon):
    """Least time for one rebase_frame call: the originals, the words and
    each inter macroblock's 384 reference pixels in, the output words and
    the reconstruction out for every macroblock; per macroblock 24
    transform chains, Y2, and an intra one's prediction or an inter one's
    six-tap passes (2 operations a tap of the passes its vectors' phases
    need, as mc_bound counts them)."""
    R, C = words.shape[:2]
    n = R * C
    inter_mask = words[..., rebase.W_REF] != 0
    inter = int(inter_mask.sum().item())
    bytes_ = n * (384 + rebase.MB_WORDS * 4 + rebase.OUT_WORDS * 2 + 384) \
        + inter * 384
    mv = words[inter_mask]
    taps = 0
    for w, blocks_per_vec in ((mv[:, rebase.W_MV:rebase.W_MV + 16], 1),
                              (mv[:, rebase.W_UVMV:rebase.W_UVMV + 4], 2)):
        fx = ((w << 16) >> 16) & 7
        fy = (w >> 16) & 7
        taps += int(((fx != 0).sum() * 9 * 4 * 6 + (fy != 0).sum() * 16 * 6)
                    .item()) * blocks_per_vec
    ops = n * (24 * RESIDUE_OPS_BLOCK + RESIDUE_OPS_Y2) \
        + (n - inter) * RESIDUE_OPS_PRED + 2 * taps
    return bound(bytes_, ops)


def rebase_case(label, args, repeats=0):
    """The residue kernel against its plain version (kernel_case), with
    the wrapper's own time on one set of planes beside it (``in_place_ms``:
    the call the rebase makes, without the comparison's copies), the
    longest intra chain and the coefficient fetch's ms (one copy of the
    output words, as reencode_device makes it)."""
    orig, refs, words, quant, recon = args
    planes = [p.clone() for p in recon]
    call = lambda: rebase_cuda.rebase_frame(orig, refs, words, quant, planes)
    in_place = time_ms(call, 20)
    host = words.cpu().numpy()
    intra = host[..., rebase.W_REF] == 0
    return kernel_case(
        "rebase_frame", label, residue_call(rebase_cuda.rebase_frame),
        residue_call(rebase.rebase_frame_plain), args,
        lambda: rebase_cuda.kernel_launches, rebase_bound, repeats=repeats,
        in_place_ms=in_place, fetch_ms=fetch_ms(call()),
        mbs=int(intra.size), intra_mbs=int(intra.sum()),
        bpred_mbs=int((intra & (host[..., rebase.W_YMODE] == T.B_PRED))
                      .sum()),
        splitmv_mbs=int((~intra & (host[..., rebase.W_YMODE] == T.SPLITMV))
                        .sum()),
        intra_chain=intra_chain(host[..., rebase.W_REF],
                                host[..., rebase.W_YMODE]),
        quant=list(quant))


def rebase_synthetic(seed, width, height, qi, kind):
    """Seeded rebase_frame arguments on the card: random references,
    originals near LAST.  ``kind`` "splitmv_extreme": every macroblock inter
    and SPLITMV, vectors up to a frame width plus 64 pixels outside the
    frame; "whole": every macroblock inter, one short vector each;
    "intra": every macroblock intra (the longest chain), the luma modes
    cycling DC, V, H, TM, B_PRED with random b-modes, the chroma modes
    DC, V, H, TM; "mixed": 60 % intra as "intra", the rest as "whole" or
    SPLITMV."""
    rng = np.random.default_rng(seed)
    R, C = height // 16, width // 16
    dims = ((height, width), (height // 2, width // 2),
            (height // 2, width // 2))
    refs = [torch.from_numpy(rng.integers(0, 256, (3,) + d, dtype=np.uint8))
            .to(DEV) for d in dims]
    orig = [torch.clamp(r[0].to(torch.int32) + torch.from_numpy(
        rng.integers(-40, 41, d)).to(DEV), 0, 255).to(torch.uint8)
        for r, d in zip(refs, dims)]
    intra = np.full((R, C), kind == "intra") if kind != "mixed" \
        else rng.random((R, C)) < 0.6
    ref = np.where(intra, 0, rng.integers(1, 4, (R, C)))
    split = np.full((R, C), kind == "splitmv_extreme") if kind != "mixed" \
        else rng.random((R, C)) < 0.5
    k = np.cumsum(intra).reshape(R, C)
    ymode = np.where(intra, k % 5, np.where(split, T.SPLITMV, T.NEWMV))
    uvmode = np.where(intra, k % 4, 0)
    bmode = rng.integers(0, 10, (R, C, 4, 4))
    span = 8 * (width + 64) if kind == "splitmv_extreme" else 40
    sub_mv = rng.integers(-span, span + 1, (R, C, 4, 4, 2))
    sub_mv[~split] = sub_mv[~split][:, :1, :1]
    # the chroma vectors as the parser derives them (luma_to_chroma)
    s = sub_mv.reshape(R, C, 2, 2, 2, 2, 2).sum(axis=(3, 5))
    uv_mv = np.where(s >= 0, (s + 4) >> 3, -((-s + 4) >> 3))
    words = torch.from_numpy(rebase.mb_words(ref, ymode, uvmode, bmode,
                                             sub_mv, uv_mv)).to(DEV)
    q = QuantIndices(y_ac_qi=qi).quantizer()
    return (orig, {p: tuple(r) for p, r in zip("yuv", refs)}, words,
            [int(q[k]) for k in QUANT_KEYS],
            [torch.zeros_like(o) for o in orig])


class FrameSink:
    """An IVFWriter's stand-in that keeps the frames and, given an
    encoder, its minihash after each."""

    def __init__(self, encoder=None):
        self.payloads, self.minihashes, self.encoder = [], [], encoder

    @property
    def frame_count(self):
        return len(self.payloads)

    def append_frame(self, payload):
        self.payloads.append(payload)
        if self.encoder is not None:
            self.minihashes.append(self.encoder.minihash())


def rebase_setup(frames, width, height):
    """Chunk 0 (frames 0-2) and the independent prediction chunk (frames
    3-5), each encoded at REBASE_QI by a new Encoder on the card: (chunk
    0's exit state as .state bytes, the prediction's payloads)."""
    enc0 = Encoder(width, height, device=DEV)
    for k in range(REBASE_CHUNK):
        enc0.encode_with_quantizer(frames[k], REBASE_QI)
    encp = Encoder(width, height, device=DEV)
    payloads = [encp.encode_with_quantizer(frames[k], REBASE_QI)
                for k in range(REBASE_CHUNK, REBASE_FRAMES)]
    return serdes.save_decoder(enc0.state, enc0.references), payloads


def rebase_run(frames, width, height, state, pred, hashes=False):
    """``reencode`` of frames 3-5 against ``state`` (.state bytes) with the
    parsed prediction ``pred``, by a new Encoder on the card: (the
    FrameSink, seconds of the reencode call, device drained at both
    ends)."""
    enc = Encoder(width, height, device=DEV)
    enc.state, enc.references = serdes.load_decoder(state, device=DEV)
    sink = FrameSink(enc if hashes else None)
    t0 = sync_clock()
    RB.reencode(enc, frames[REBASE_CHUNK:REBASE_FRAMES], pred,
                REBASE_KF_WEIGHT, False, sink)
    return sink, sync_clock() - t0


def rebase_kernel_inputs(frames, width, height):
    """The residue kernel's arguments for rebased frames 4 and 5 (the
    rebase's residue updates), captured from a rebase run; the
    reconstruction planes as the kernel received them."""
    state, payloads = rebase_setup(frames, width, height)
    pred = RB.parse_prediction(payloads, Decoder(width, height, device=DEV))
    kept = []
    real = reencode_device.rebase_frame

    def capture(orig, refs, words, quant, recon):
        kept.append((orig, refs, words, list(quant),
                     [p.clone() for p in recon]))
        return real(orig, refs, words, quant, recon)

    reencode_device.rebase_frame = capture
    try:
        rebase_run(frames, width, height, state, pred)
    finally:
        reencode_device.rebase_frame = real
    return kept


def fetch_ms(out, reps=20):
    """The rebase's coefficient fetch (one device-to-host copy of the
    output words, as reencode_device makes it): median ms over ``reps``
    copies, the device drained before each."""
    times = []
    for _ in range(reps):
        t0 = sync_clock()
        out.cpu()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def write_y4m(path, frames, width, height):
    with Y4MWriter(path, width, height) as w:
        for y, u, v in frames:
            w.append_frame(y, u, v)


REBASE_SPANS = ("rebase.inputs", "rebase.kernel", "rebase.fetch",
                "rebase.lf", "rebase.serialize",
                "enc.inter_inputs", "enc.inter_kernel", "enc.inter_fetch",
                "enc.inter_host")


def rebase_phase(card, width, height, frames, fetch):
    """The rebase phase: ExCamera's xc-enc -I/-O and -r through the port's
    CLI on decoded frames 0-5 (see the module docstring); ``fetch``: the
    coefficient fetch's ms from the kernels phase.  Returns its result
    line."""
    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    f = lambda name: os.path.join(work, name)
    write_y4m(f("chunk0.y4m"), frames[:REBASE_CHUNK], width, height)
    write_y4m(f("chunk1.y4m"), frames[REBASE_CHUNK:], width, height)
    qi = str(REBASE_QI)
    xc.main(["enc", f("chunk0.y4m"), "-y", qi, "-o", f("chunk0.ivf"),
             "-O", f("chunk0.state")])
    xc.main(["enc", f("chunk1.y4m"), "-y", qi, "-o", f("pred.ivf")])

    # the rebase path: counters to 0 just before, read just after
    zero_counts()
    t0 = sync_clock()
    xc.main(["enc", f("chunk1.y4m"), "-r", "-I", f("chunk0.state"),
             "-p", f("pred.ivf"), "-w", str(REBASE_KF_WEIGHT),
             "-o", f("rebased.ivf"), "-O", f("rebased.state")])
    cli_s = sync_clock() - t0
    calls, kernels = read_counts()
    rebased = list(IVFReader(f("rebased.ivf")))
    sha_ok = [hashlib.sha1(p).hexdigest() == want
              for p, want in zip(rebased, REBASE_SHA1)]

    # the same rebase through the API, the encoder's minihash after each
    # frame; the port's Decoder re-decodes each rebased frame from chunk
    # 0's state to it
    with open(f("chunk0.state"), "rb") as fh:
        state = fh.read()
    pred = RB.parse_prediction(list(IVFReader(f("pred.ivf"))),
                               Decoder(width, height, device=DEV))
    sink, _ = rebase_run(frames, width, height, state, pred, hashes=True)
    s0, r0 = serdes.load_decoder(state, device=DEV)
    dec = Decoder(width, height, state=s0, references=r0, device=DEV)
    decode_ok = []
    for p, mh in zip(rebased, sink.minihashes):
        dec.decode_frame(p)
        decode_ok.append(dec.minihash() == mh)
    s1, r1 = serdes.load_decoder(f("rebased.state"), device=DEV)
    state_ok = Decoder(width, height, state=s1, references=r1,
                       device=DEV).minihash() == sink.minihashes[-1]
    # the residue updates' intra macroblocks and their longest chains
    residue = [a for kf, _, a in pred[1:] if not kf]
    intra_mbs = [int((a.ref == T.CURRENT_FRAME).sum()) for a in residue]
    chains = [intra_chain(a.ref, a.ymode) for a in residue]

    # speed: rebased frames per second (the reencode call; the prediction
    # parsed before), better of three passes; spans from one traced pass
    passes = [rebase_run(frames, width, height, state, pred)[1]
              for _ in range(3)]
    n = len(rebased)
    tracing.enable(True)
    tracing.snapshot()
    rebase_run(frames, width, height, state, pred)
    tracing.enable(False)
    spans = tracing.snapshot()
    line = dict(
        card=card, frames=list(range(REBASE_CHUNK, REBASE_FRAMES)),
        width=width, height=height, sha1_ok=sha_ok,
        decode_minihash_ok=decode_ok, state_file_minihash_ok=state_ok,
        encoder_minihash_ok=sink.minihashes == REBASE_MINIHASH,
        api_payloads_equal_cli=sink.payloads == rebased,
        launches=calls, kernel_launches=kernels, cli_s=cli_s,
        intra_mbs_on_card=intra_mbs, longest_intra_chain=chains,
        pass_s=passes,
        rebased_frames_per_s=n / min(passes),
        ms_per_rebased_frame=min(passes) * 1e3 / n,
        traced_spans={k: {"ms": spans[k]["seconds"] * 1e3,
                          "count": spans[k]["count"]}
                      for k in REBASE_SPANS if k in spans},
        coefficient_fetch_ms=fetch,
        device_profile=device_profile(
            lambda: rebase_run(frames, width, height, state, pred)))
    say("rebase", **line)
    if len(rebased) != len(REBASE_SHA1) or not all(sha_ok):
        raise SystemExit("rebased frames differ from REBASE_SHA1")
    if not (all(decode_ok) and state_ok and line["api_payloads_equal_cli"]
            and line["encoder_minihash_ok"]):
        raise SystemExit("the rebased stream does not re-decode to the "
                         "encoder's minihash, or that differs from "
                         "REBASE_MINIHASH")
    if calls["rebase_frame"] != n - 1 or calls["encode_inter_frame"] != 1:
        raise SystemExit("the rebase made other than one residue-kernel "
                         "call a residue update and one K8 call")
    if calls["predict_mb_tiles"] <= 0 or calls["loop_filter"] <= 0 \
            or calls["intra_frame"] <= 0:
        raise SystemExit("the rebase path did not launch K3, K4 and K5")
    return line


# ------------------------------------------------------------- xc tools

# xc_tools: ExCamera's chunk toolchain through the port's CLI on the rebase
# phase's files (chunk0.ivf and chunk0.state from xc enc -y 48 -O of
# decoded frames 0-2, pred.ivf and chunk1.y4m of frames 3-5).  SHA-1 of
# what the JAX package's CLI makes of the same files: XC_TOOLS_ZERO_SHA1,
# each frame of xc zero-out-residues pred.ivf; XC_TOOLS_ZERO_DECODED_SHA1,
# the y4m that xc decode writes of it; XC_TOOLS_TEXT_SHA1, (exit code,
# SHA-1 of stdout) of xc diff and comp-states of chunk0.state against the
# terminated chunk's state (chunk0t.state: the same bits, as the JAX CLI
# finds too) and of the state after the terminated chunk's frame 0 (dump
# -f 0) against it (they differ), xc ssim of the
# merged stream against frames 0-5, xc dissect -m -p -C -f 1 pred.ivf and
# xc dissect -s chunk0t.state -f 0 of the rebased chunk.  The terminated
# and rebased chunks are CLUSTER_SHA1's frames.  Computed once on a CPU
# host; tests/test_torch_xc_tools.py recomputes them (-m slow).
XC_TOOLS_ZERO_SHA1 = ["2ecd986d30f7001fc9957f97419164bf527e3328",
                      "7b7296b1d96c291f6276cd68ca675d817e72a5fe",
                      "a2b1235bc734a1bac6b5b1eefdb9eaef40f02057"]
XC_TOOLS_ZERO_DECODED_SHA1 = "1efb5a269012978cbe2b9309ff90c06542f65c57"
XC_TOOLS_TEXT_SHA1 = {
    "diff encoder terminated": [0, "1308c30e43ad584712eebf58f446a7c7817b9a16"],
    "comp-states encoder terminated":
        [0, "e32c47341384d100df9ad4b53e15ebce553d2574"],
    "diff frame0 terminated": [1, "9d4db4636894a8f9ecc1706d458d301a17491da2"],
    "comp-states frame0 terminated":
        [1, "7e5b5626578f03ff71ab6d494aaa2696ae0e082f"],
    "ssim": [0, "be6c604848e4cdaa860d3d4491cde3bc242a7fec"],
    "dissect pred": [0, "74b36575c38969522d4009696358d3b0adc65f2c"],
    "dissect rebased": [0, "22e7b344fd7ac50c0f9ffbafe8e199054445bf86"]}
# the kernels of K3, K4 and K5, as torch.profiler names them
PROFILE_KERNELS = ("mc_planes_kernel", "intra_row_kernel", "lf_row_kernel")


def run_xc(argv, stdin=None):
    """The port's xc.main(argv) in this process, on the card: (exit code,
    stdout, stderr, wall ms with the device drained at both ends)."""
    import contextlib
    import io
    out, err = io.StringIO(), io.StringIO()
    saved = sys.stdin
    if stdin is not None:
        sys.stdin = io.StringIO(stdin)
    t0 = sync_clock()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                rc = xc.main(argv)
            except SystemExit as e:
                rc = e.code
    finally:
        sys.stdin = saved
    return rc or 0, out.getvalue(), err.getvalue(), (sync_clock() - t0) * 1e3


def frame_sha1(path):
    return [hashlib.sha1(p).hexdigest() for p in IVFReader(path)]


def text_sha1(rc, out):
    return [rc, hashlib.sha1(out.encode()).hexdigest()]


def residue_update_ms(frames, width, height, state, pred):
    """One traced rebase of frames 3-5: (the residue update's ms per
    residue-update frame, its ``rebase.inputs``, ``rebase.kernel`` and
    ``rebase.fetch`` spans summed; whether its frames are REBASE_SHA1's)."""
    tracing.enable(True)
    tracing.snapshot()
    try:
        sink, _ = rebase_run(frames, width, height, state, pred)
    finally:
        tracing.enable(False)
    spans = tracing.snapshot()
    n = REBASE_FRAMES - REBASE_CHUNK - 1
    ms = sum(spans[k]["seconds"] for k in ("rebase.inputs", "rebase.kernel",
                                           "rebase.fetch")) * 1e3 / n
    return ms, [hashlib.sha1(p).hexdigest() for p in sink.payloads] \
        == REBASE_SHA1


def xc_tools_phase(card, width, height, frames):
    """The xc_tools phase: ExCamera's chunk workflow through the port's xc
    on the card, on the rebase phase's files (see the module docstring);
    then the residue update's ms a frame, four turns.  Returns its result
    line."""
    work = os.path.join(REPO, "build", "chip_smoke")
    f = lambda name: os.path.join(work, name)
    write_y4m(f("all.y4m"), frames, width, height)
    gates, ms = {}, {}
    profile_dir = f("profile")
    if os.path.isdir(profile_dir):
        for old in os.listdir(profile_dir):
            os.remove(os.path.join(profile_dir, old))

    def step(name, argv, stdin=None):
        rc, out, err, wall = run_xc(argv, stdin)
        ms[name] = wall
        return rc, out, err

    # the path: counters to 0 just before, read just after
    zero_counts()
    step("terminate-chunk", ["terminate-chunk", f("chunk0.ivf"),
                             f("chunk0t.ivf"), "-O", f("chunk0t.state")])
    gates["terminate-chunk"] = (frame_sha1(f("chunk0t.ivf"))
                                == CLUSTER_SHA1[:REBASE_CHUNK])
    step("dump", ["dump", f("chunk0t.ivf"), f("dump.state")])
    step("dump -f 0", ["dump", f("chunk0t.ivf"), f("dump0.state"), "-f", "0"])
    with open(f("dump.state"), "rb") as a, open(f("chunk0t.state"), "rb") as b:
        gates["dump"] = a.read() == b.read()
    texts = {}
    for a, key in (("dump", "dump"), ("chunk0", "encoder"),
                   ("dump0", "frame0")):
        for cmd in ("diff", "comp-states"):
            name = f"{cmd} {key} terminated"
            rc, out, _ = step(name, [cmd, f(a + ".state"),
                                     f("chunk0t.state")])
            texts[name] = (rc, out)
    gates["diff and comp-states"] = (
        texts["diff dump terminated"] == (0, "states are identical\n")
        and texts["comp-states dump terminated"] == (0, "0 bits differ\n")
        and all(text_sha1(*texts[k]) == XC_TOOLS_TEXT_SHA1[k]
                for k in texts if "dump" not in k))
    step("enc -r", ["enc", f("chunk1.y4m"), "-r", "-I", f("chunk0t.state"),
                    "-p", f("pred.ivf"), "-w", str(REBASE_KF_WEIGHT),
                    "-o", f("rebased_t.ivf")])
    gates["enc -r"] = (frame_sha1(f("rebased_t.ivf"))
                       == CLUSTER_SHA1[REBASE_CHUNK:])
    step("merge", ["merge", f("chunk0t.ivf"), f("rebased_t.ivf"), "-o",
                   f("merged.ivf")])
    gates["merge"] = frame_sha1(f("merged.ivf")) == CLUSTER_SHA1
    _, sizes, _ = step("framesize", ["framesize", f("merged.ivf")])
    gates["framesize"] = sizes.split() == [
        str(len(p)) for p in IVFReader(f("merged.ivf"))]
    bundle = f("chunk0t.ivf") + "\n" + f("rebased_t.ivf") + "\n"
    step("decode-bundle", ["decode-bundle", f("bundle.y4m")], bundle)
    step("decode", ["decode", f("merged.ivf"), f("merged.y4m")])
    with open(f("bundle.y4m"), "rb") as a, open(f("merged.y4m"), "rb") as b:
        gates["decode-bundle"] = a.read() == b.read()
    rc, out, _ = step("ssim", ["ssim", f("merged.ivf"), f("all.y4m")])
    gates["ssim"] = text_sha1(rc, out) == XC_TOOLS_TEXT_SHA1["ssim"]
    ssim_values = [float(l.split(", ")[1]) for l in out.splitlines()]
    step("zero-out-residues", ["zero-out-residues", f("pred.ivf"),
                               f("zero.ivf")])
    step("decode zero", ["decode", f("zero.ivf"), f("zero.y4m")])
    with open(f("zero.y4m"), "rb") as z:
        gates["zero-out-residues"] = (
            frame_sha1(f("zero.ivf")) == XC_TOOLS_ZERO_SHA1
            and hashlib.sha1(z.read()).hexdigest()
            == XC_TOOLS_ZERO_DECODED_SHA1)
    dissect_ok = []
    for name, argv in (("dissect pred", ["-m", "-p", "-C", "-f", "1",
                                         f("pred.ivf")]),
                       ("dissect rebased", ["-s", f("chunk0t.state"), "-f",
                                            "0", f("rebased_t.ivf")])):
        rc, out, _ = step(name, ["dissect"] + argv)
        dissect_ok.append(text_sha1(rc, out) == XC_TOOLS_TEXT_SHA1[name])
    gates["dissect"] = all(dissect_ok)

    # the flags: the stage report of a bundle decode (the decoder's
    # minihash recorded after each frame), a torch.profiler trace of a
    # decode
    minihashes = []
    real = Decoder.decode_frame

    def recording(self, payload):
        shown_raster = real(self, payload)
        minihashes.append(self.minihash())
        return shown_raster

    Decoder.decode_frame = recording
    try:
        _, _, report = step("--timings decode-bundle",
                               ["--timings", "decode-bundle",
                                f("bundle_t.y4m")], bundle)
    finally:
        Decoder.decode_frame = real
    gates["decode-bundle minihash"] = minihashes == CLUSTER_MINIHASH
    gates["--timings"] = ("-- stage timings --" in report
                          and "decode.reconstruct" in report)
    _, _, note = step("--profile decode", ["--profile", profile_dir,
                                              "decode", f("merged.ivf"),
                                              f("merged_p.y4m")])
    traces = os.listdir(profile_dir)
    with open(os.path.join(profile_dir, traces[0])) as fh:
        names = {e.get("name", "") for e in json.load(fh)["traceEvents"]}
    gates["--profile"] = (len(traces) == 1 and traces[0] in note and all(
        any(k in n for n in names) for k in PROFILE_KERNELS))
    calls, kernels = read_counts()

    # the residue update's ms a frame (the kernel with its upload and
    # fetch), four turns
    with open(f("chunk0.state"), "rb") as fh:
        state = fh.read()
    pred = RB.parse_prediction(list(IVFReader(f("pred.ivf"))),
                               Decoder(width, height, device=DEV))
    turns = [residue_update_ms(frames, width, height, state, pred)
             for _ in range(4)]
    gates["rebase turns"] = all(ok for _, ok in turns)
    line = dict(
        card=card, width=width, height=height, gates=gates, wall_ms=ms,
        total_ms=sum(ms.values()), ssim=ssim_values, launches=calls,
        kernel_launches=kernels, stage_report=report.splitlines(),
        residue_update_ms_per_frame=[ms for ms, _ in turns])
    say("xc_tools", **line)
    failed = [k for k, ok in gates.items() if not ok]
    if failed:
        raise SystemExit("xc_tools gates failed: " + ", ".join(failed))
    if min(calls[k] for k in ("predict_mb_tiles", "intra_frame",
                              "loop_filter")) <= 0:
        raise SystemExit("the xc tools did not launch K3, K4 and K5")
    if calls["encode_inter_frame"] != 1 or calls["rebase_frame"] != \
            REBASE_FRAMES - REBASE_CHUNK - 1:
        raise SystemExit("xc enc -r onto the terminated state made other "
                         "than one K8 call and a residue-kernel call a "
                         "residue update")
    return line


def cluster_phase(card, width, height, frames):
    """The cluster phase: xc enc-parallel with two worker processes on the
    card, then the serial rebase (see the module docstring); returns its
    result line."""
    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    src, out = (os.path.join(work, n) for n in ("all.y4m", "cluster.ivf"))
    write_y4m(src, frames, width, height)
    zero_counts()
    t0 = sync_clock()
    xc.main(["enc-parallel", src, "-y", str(REBASE_QI), "-c",
             str(REBASE_CHUNK), "-j", "2", "-w", str(REBASE_KF_WEIGHT),
             "-o", out])
    cli_s = sync_clock() - t0
    calls, kernels = read_counts()
    stitched = list(IVFReader(out))
    sha_ok = [hashlib.sha1(p).hexdigest() == want
              for p, want in zip(stitched, CLUSTER_SHA1)]
    # the stitched stream decoded from scratch, frame for frame
    player = FilePlayer(out, device=DEV)
    minihashes = [player.decoder.minihash() for _ in player]

    # the two phases' wall times: parallel_encode called directly, the
    # clock read at its log line after phase 1
    marks = []
    sink = FrameSink()
    t0 = sync_clock()
    parallel_encode(frames, width, height, sink, y_ac_qi=REBASE_QI,
                    chunk_frames=REBASE_CHUNK, workers=2,
                    kf_q_weight=REBASE_KF_WEIGHT, device=DEV,
                    log=lambda m: marks.append((m, sync_clock() - t0)))
    total = sync_clock() - t0
    phase1 = marks[0][1]
    line = dict(card=card, frames=list(range(len(frames))), width=width,
                height=height, workers=2, chunk_frames=REBASE_CHUNK,
                sha1_ok=sha_ok, decode_minihash_ok=[
                    a == b for a, b in zip(minihashes, CLUSTER_MINIHASH)],
                api_payloads_equal_cli=sink.payloads == stitched,
                launches_in_this_process=calls,
                kernel_launches_in_this_process=kernels, cli_s=cli_s,
                phase1_s=phase1, phase2_s=total - phase1, total_s=total,
                frames_per_s=len(frames) / total)
    say("cluster", **line)
    if len(stitched) != len(CLUSTER_SHA1) or not all(sha_ok):
        raise SystemExit("stitched frames differ from CLUSTER_SHA1")
    if len(minihashes) != len(CLUSTER_MINIHASH) \
            or not all(line["decode_minihash_ok"]) \
            or not line["api_payloads_equal_cli"]:
        raise SystemExit("the stitched stream does not decode to "
                         "CLUSTER_MINIHASH")
    if calls["rebase_frame"] <= 0 or calls["encode_inter_frame"] <= 0:
        raise SystemExit("the cluster's rebase did not launch K8 and the "
                         "residue kernel")
    return line


# ------------------------------------------------------------- Salsify

# the salsify phase: decoded frames 0-5 repeated to SALSIFY_FRAMES frames;
# the lossy run drops SALSIFY_DROP (fragment 0 of frame 2) once, as
# tests/test_salsify.py does; conventional mode over its own frame count
SALSIFY_FRAMES, SALSIFY_CONVENTIONAL_FRAMES = 30, 12
SALSIFY_DROP = (2, 0)


class RepeatedFrames(FrameInput):
    """The sender's frame source: ``frames`` in order, then None."""

    def __init__(self, frames, width, height):
        self.frames, self.i = frames, 0
        self.width, self.height = width, height

    def get_next_frame(self):
        if self.i >= len(self.frames):
            return None
        self.i += 1
        return self.frames[self.i - 1]

    @property
    def display_width(self):
        return self.width

    @property
    def display_height(self):
        return self.height


def pct(values, q):
    return float(np.percentile(values, q)) if len(values) else None


def salsify_run(frames, width, height, mode, drop=None):
    """The port's SalsifySender and SalsifyReceiver on loopback UDP in this
    process, both on the card, both sockets on port 0.  Each frame sent is
    logged with its source state (copied: prune_encoders drops old
    encoders), payload and target minihash; the receiver's decode calls
    are timed with the device drained.  Returns (sender, receiver,
    received rasters, the log, decode ms, frames grabbed)."""
    received, decode_ms, log = [], [], []
    expect = len(frames) - (drop is not None)
    receiver = SalsifyReceiver(0, width, height, host="127.0.0.1",
                               on_raster=received.append, device=DEV)
    decode = receiver.player.decode

    def timed_decode(payload):
        t0 = time.perf_counter()
        raster = decode(payload)
        torch.cuda.synchronize()
        decode_ms.append((time.perf_counter() - t0) * 1e3)
        return raster
    receiver.player.decode = timed_decode
    dropped = []
    if drop is not None:
        recv = receiver.socket.recv

        def lossy_recv(*a):
            while True:
                d = recv(*a)
                p = Packet.parse(d.payload)
                if (p.frame_no, p.fragment_no) == drop and not dropped:
                    dropped.append(drop)
                    continue
                return d
        receiver.socket.recv = lossy_recv

    def serve():
        try:
            receiver.run(max_frames=expect, timeout_ms=60000)
        except (OSError, ValueError):
            pass                # its socket closed under it (below)

    rt = threading.Thread(target=serve, daemon=True)
    rt.start()
    source = RepeatedFrames(frames, width, height)
    sender = SalsifySender("127.0.0.1", receiver.socket.getsockname()[1],
                           1337, source, mode=mode,
                           drop_frames_while_busy=False, device=DEV)
    send = sender._send_output

    def logged(output):
        src = sender.encoders[output.source_minihash]
        log.append((output.source_minihash, src.state.copy(),
                    src.references.copy(), bytes(output.frame),
                    output.encoder.minihash(), output.job_name,
                    output.y_ac_qi))
        return send(output)
    sender._send_output = logged
    try:
        sender.run(max_frames=len(frames))
        # every frame sent is displayed but one that lost its fragment 0
        # (its prefix is empty), or the receiver stops at ``expect``
        shown = sender.frames_sent - sum(f == 0 for _, f in dropped)
        deadline = time.monotonic() + 30
        while rt.is_alive() and len(received) < shown \
                and time.monotonic() < deadline:
            rt.join(0.1)
    finally:
        sender.close()
        receiver.close()
        rt.join(5)
    return sender, receiver, received, log, decode_ms, source.i


def salsify_phase(card, width, height):
    """The salsify phase: Salsify's sender and receiver through the port
    at 720p on loopback (s2 lossless, s2 with a fragment dropped,
    conventional); returns its result line."""
    rasters = decoded_frames(CLIP, tuple(range(6)))
    frames = [rasters[k % 6].display() for k in range(SALSIFY_FRAMES)]
    zero_counts()
    t0 = time.perf_counter()
    runs = {"s2_lossless": salsify_run(frames, width, height, "s2"),
            "s2_lossy": salsify_run(frames, width, height, "s2",
                                    SALSIFY_DROP),
            "conventional": salsify_run(
                frames[:SALSIFY_CONVENTIONAL_FRAMES], width, height,
                "conventional")}
    wall = time.perf_counter() - t0
    calls, kernels = read_counts()      # every thread joined
    line = dict(card=card, width=width, height=height, runs_wall_s=wall,
                launches=calls, kernel_launches=kernels,
                salsify_design_point_ms=SALSIFY_MS, runs={})
    ok = {}
    for name, (snd, rcv, received, log, dec_ms, grabbed) in runs.items():
        # each payload, decoded from the advertised source state by a
        # fresh Decoder, reaches the advertised target minihash
        reaches = []
        for _src, state, refs, payload, target, _job, _q in log:
            d = Decoder(width, height, state=state.copy(), references=refs,
                        device=DEV)
            d.decode_frame(payload)
            reaches.append(d.minihash() == target)
        enc_ms = [e[4] for e in snd.sent_log]
        gaps = [(b[3] - a[3]) * 1e3
                for a, b in zip(snd.sent_log, snd.sent_log[1:])]
        sizes = [e[1] for e in snd.sent_log]
        r = dict(frames_grabbed=grabbed, frames_sent=snd.frames_sent,
                 frames_received=len(received),
                 frames_skipped=grabbed - snd.frames_sent,
                 next_frame_no=rcv.next_frame_no,
                 state_agrees=rcv.current_state == snd.receiver_assumed_state,
                 payloads_reach_target=reaches,
                 jobs=[e[5] for e in log], quantizers=[e[6] for e in log],
                 key_frame_encode_ms=enc_ms[:1],
                 encode_ms_p50=pct(enc_ms[1:], 50),
                 encode_ms_p95=pct(enc_ms[1:], 95),
                 frame_gap_ms_p50=pct(gaps, 50),
                 frame_gap_ms_p95=pct(gaps, 95),
                 bytes_per_frame_mean=float(np.mean(sizes)) if sizes else None,
                 bytes_per_frame_max=max(sizes, default=None),
                 decode_ms_p50=pct(dec_ms, 50), decode_ms_p95=pct(dec_ms, 95),
                 sent_log_encode_ms=enc_ms)
        if name != "s2_lossy":
            last = snd.encoders[snd.receiver_assumed_state].references.last
            r["last_raster_equal"] = bool(received) and all(
                torch.equal(a, b) for a, b in zip(
                    (received[-1].y, received[-1].u, received[-1].v),
                    (last.y, last.u, last.v)))
            ok[name] = (r["frames_received"] == r["frames_sent"] > 0
                        and r["state_agrees"] and r["last_raster_equal"]
                        and all(reaches))
        else:
            ok[name] = (r["frames_sent"] >= 3
                        and r["frames_received"] >= r["frames_sent"] - 2
                        and r["next_frame_no"] >= 3 and all(reaches))
        line["runs"][name] = r
    line["gates_ok"] = ok
    say("salsify", **line)
    if not all(ok.values()):
        raise SystemExit("a Salsify loopback run failed its gates: %s"
                         % sorted(k for k, v in ok.items() if not v))
    for k in ("predict_mb_tiles", "intra_frame", "loop_filter",
              "encode_kf_frame", "decide_inter_frame", "intra_fixup_frame"):
        if calls[k] <= 0:
            raise SystemExit("the Salsify path did not launch %s" % k)
    if calls["encode_inter_frame"]:
        raise SystemExit("the Salsify path launched K8 (the fast path is "
                         "its default)")
    return line


# ------------------------------------------------------------ the mesh

MESH_SHARDS = 4          # the 4-shard mesh over cuda:0: four ring hops
MESH_CHAIN_FRAMES = 2


def plane_sha1(planes):
    return hashlib.sha1(b"".join(
        np.ascontiguousarray(p.cpu().numpy()).tobytes()
        for p in planes)).hexdigest()


def mesh_decode_inputs(payloads, width, height, frames):
    """gop_decode_step's batch for ``frames`` (interframes) of the clip:
    each frame's parse arrays and its reference stacks (on the card) as the
    single-frame Decoder holds them before it, and the SHA-1 of the planes
    that Decoder then decodes."""
    from alfalfa_tpu_torch.bitstream.header import UncompressedChunk
    from alfalfa_tpu_torch.decoder.lf_params import frame_lf_params
    from alfalfa_tpu_torch.decoder.parse import FrameParser
    dec = Decoder(width, height, device=DEV)
    per, want = [], []
    for f, p in enumerate(payloads[:max(frames) + 1]):
        if f in frames:
            st = dec.state.copy()
            header, arrays, _ = FrameParser(st).parse(
                UncompressedChunk(p, width, height))
            r = dec.references
            stack = [torch.stack([getattr(x, c) for x in (
                r.last, r.last, r.golden, r.alternative)]) for c in "yuv"]
            per.append((arrays, RT._frame_quant_factors(
                header, st, arrays.segment),
                frame_lf_params(header, arrays, st, False), stack))
        _, raster = dec.decode_frame(p)
        if f in frames:
            want.append(plane_sha1((raster.y, raster.u, raster.v)))
    a = [x[0] for x in per]
    field = lambda k: np.stack([getattr(x, k) for x in a])
    batch = (np.stack([x.densify_coeffs() for x in a]),
             {k: np.stack([x[1][k] for x in per])
                               for k in per[0][1]},
             field("y2_coded"), field("has_nonzero"), field("ymode"),
             field("uvmode"), field("bmode"), field("ref"), field("sub_mv"),
             field("uv_mv"),
             *(torch.stack([x[3][c] for x in per]) for c in range(3)),
             tuple(np.stack([x[2][i] for x in per]) for i in range(6)))
    return batch, want


def serial_chain(inputs, refs0, width, height):
    """gop_rebase_chain's chain computed serially, frame by frame, through
    the rebase's residue update (encoder/reencode_device.
    apply_residues_device) on the card: (coeffs (N, F, n_mb, 400),
    nz (N, F, n_mb), exit_y (4, H, W))."""
    from alfalfa_tpu_torch.decoder.parse import FrameArrays
    from alfalfa_tpu_torch.state.decoder_state import References
    oy, ou, ov, refsel, smv, uvmv, splitmv, qs = inputs
    R, C = refsel.shape[2:]
    dev_raster = lambda planes: Raster(width, height, *(
        torch.from_numpy(np.ascontiguousarray(p)).to(DEV) for p in planes))
    refs = References(*(dev_raster([s[k] for s in refs0])
                        for k in (1, 2, 3)))
    co, nz = [], []
    for d in range(len(oy)):
        q = dict(zip(QUANT_KEYS, (int(x) for x in qs[d][:6])))
        for f in range(oy.shape[1]):
            arrays = FrameArrays(R, C)
            arrays.ref[:] = refsel[d, f]
            arrays.sub_mv[:] = smv[d, f]
            arrays.uv_mv[:] = uvmv[d, f]
            arrays.ymode[:] = np.where(splitmv[d, f], T.SPLITMV, T.NEWMV)
            orig = [torch.from_numpy(x[d, f].astype(np.uint8)).to(DEV)
                    for x in (oy, ou, ov)]
            recon = Raster(width, height,
                           *(torch.zeros_like(o) for o in orig))
            reencode_device.apply_residues_device(orig, recon, arrays, q,
                                                  refs)
            co.append(arrays.coeffs.reshape(R * C, 400).copy())
            nz.append(arrays.has_nonzero.reshape(R * C).copy())
            refs = References(recon, refs.golden, refs.alternative)
        refs = References(recon, recon, recon)
    n, F = oy.shape[:2]
    return (torch.from_numpy(np.stack(co).reshape(n, F, R * C, 400)),
            torch.from_numpy(np.stack(nz).reshape(n, F, R * C)),
            refs.last.y[None].repeat(4, 1, 1))


def mesh_run(mesh, width, height, dec_batch, dec_want, enc_want, chain_in,
             chain_want):
    """The three steps on one mesh, timed (device drained at both ends),
    each held to its serial counterpart.  Returns (result, gates met)."""
    R, C = height // 16, width // 16
    n = len(mesh)
    t0 = sync_clock()
    y, u, v, exit_y, energy = gop.gop_decode_step(mesh, R, C)(*dec_batch)
    t_dec = sync_clock() - t0
    got = [plane_sha1(p) for s in zip(y, u, v) for p in zip(*s)]
    t0 = sync_clock()
    eexit, eco = gop.gop_encode_step(mesh, R, C, MESH_SHARDS)
    t_enc = sync_clock() - t0
    t0 = sync_clock()
    co, nz, cexit = gop.gop_rebase_chain(mesh, R, C, MESH_CHAIN_FRAMES)(
        *chain_in)
    t_chain = sync_clock() - t0
    ok = {"decode_sha1": got == dec_want,
          "decode_exit_y": all(torch.equal(e.cpu(), torch.cat(
              [p[-1:] for p in y]).cpu()) for e in exit_y),
          "decode_energy_finite": all(bool(torch.isfinite(m))
                                      for m in energy),
          "encode_coeffs": torch.equal(torch.cat(eco).cpu(), enc_want[0]),
          # gathered: the last chunk of each shard
          "encode_exit_y": all(torch.equal(
              e.cpu(), enc_want[1][MESH_SHARDS // n - 1::MESH_SHARDS // n])
              for e in eexit),
          "chain_coeffs": torch.equal(torch.cat(co).cpu(), chain_want[0]),
          "chain_nz": torch.equal(torch.cat(nz).cpu(), chain_want[1]),
          "chain_exit_y": all(torch.equal(e.cpu(), chain_want[2].cpu())
                              for e in cexit)}
    return dict(devices=[str(d) for d in mesh], shards=n, chain_chunks=n,
                decode_step_ms=t_dec * 1e3, encode_step_ms=t_enc * 1e3,
                rebase_chain_ms=t_chain * 1e3,
                rebase_ms_per_hop=t_chain * 1e3 / n,
                mean_energy=float(energy[0]), gates=ok), all(ok.values())


def mesh_phase(card, width, height, payloads):
    """The multi-device GOP steps (parallel/gop.py) at 720p on the visible
    cards and on a 4-shard mesh over cuda:0: the decode step on frames 1-4
    against the single-frame Decoder's SHA-1s, the encode step (4 chunks)
    against one K7 call a chunk, the rebase ring over
    rebase_chain_inputs_from_ivf (a chunk of 2 frames a shard) against the
    serial residue update.  Counters to 0 just before each mesh's steps,
    read just after; returns the result line."""
    R, C = height // 16, width // 16
    dec_batch, dec_want = mesh_decode_inputs(payloads, width, height,
                                             (1, 2, 3, 4))
    (oy, ou, ov), quant, (rm, dm) = gop.encode_step_inputs(R, C,
                                                           MESH_SHARDS)
    one = [enc_intra_cuda.encode_kf_frame(
        *(torch.from_numpy(p[k]).to(DEV) for p in (oy, ou, ov)), quant,
        rm, dm) for k in range(MESH_SHARDS)]
    enc_want = (torch.stack([o[0].reshape(R, C, 400) for o in one]).cpu(),
                torch.stack([o[2] for o in one]).cpu())
    meshes = {"visible": gop.make_gop_mesh(),
              "cuda0_x%d" % MESH_SHARDS: gop.make_gop_mesh(
                  ["cuda:0"] * MESH_SHARDS)}
    runs, launches = {}, {}
    for name, mesh in meshes.items():
        # the ring takes one chunk a shard
        chain_in = sum(gop.rebase_chain_inputs_from_ivf(
            CLIP, len(mesh), MESH_CHAIN_FRAMES, device=DEV), ())
        chain_want = serial_chain(chain_in[:8], chain_in[8:], width, height)
        args = (mesh, width, height, dec_batch, dec_want, enc_want,
                chain_in, chain_want)
        warm = mesh_run(*args)      # first calls: allocator, libraries
        zero_counts()
        runs[name] = mesh_run(*args)
        launches[name] = read_counts()
        runs[name][0]["first_pass_gates_met"] = warm[1]
    calls = {k: sum(c[k] for c, _ in launches.values()) for k in COUNTS}
    kernels = {k: sum(n[k] for _, n in launches.values()) for k in COUNTS}
    line = dict(card=card, width=width, height=height,
                decode_frames=[1, 2, 3, 4], encode_chunks=MESH_SHARDS,
                chain_frames=MESH_CHAIN_FRAMES,
                runs={k: r for k, (r, _) in runs.items()},
                launches_by_mesh={k: c for k, (c, _) in launches.items()},
                launches=calls, kernel_launches=kernels)
    say("mesh", **line)
    if not all(ok and r["first_pass_gates_met"] for r, ok in runs.values()):
        raise SystemExit("a mesh step differs from its serial counterpart")
    for name, mesh in meshes.items():
        chain = len(mesh) * MESH_CHAIN_FRAMES
        want = {"predict_mb_tiles": 4, "intra_frame": 4,
                "loop_filter": 4, "encode_kf_frame": MESH_SHARDS,
                "rebase_frame": chain}
        got = launches[name][0]
        if any(got[k] != v for k, v in want.items()):
            raise SystemExit("the %s mesh made other kernel calls than %s: "
                             "%s" % (name, want, got))
    return line


# ----------------------------------------------------------- main path

def decode_all(payloads, width, height, digest, engine="auto"):
    dec = gop.BatchedGopDecoder(width, height, G, device=DEV,
                                token_engine=engine)
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


def host_cpu():
    """The host CPU's model name and AVX-512 flags (/proc/cpuinfo) and its
    core count."""
    info = {}
    try:
        with open("/proc/cpuinfo") as fh:
            for l in fh:
                k, _, v = l.partition(":")
                info.setdefault(k.strip(), v.strip())
    except OSError:
        pass
    return {"model": info.get("model name"), "cores": os.cpu_count(),
            "avx512": sorted(f for f in info.get("flags", "").split()
                             if f.startswith("avx512"))}


def simd_main_path(card, payloads, width, height, want):
    """main_path with the AVX-512 token engine (token_engine="simd") on at
    least two parse threads: the manifest SHA-1 of every GOP, each
    engine's calls, and gop.parse ms a frame position for the scalar
    parser (its threads) and the engine in turns (scalar, SIMD, SIMD,
    scalar).  Returns the result line, or None where the host CPU has no
    AVX-512 (said on a line of its own)."""
    if not bitwork.simd_supported():
        print("main_path_simd: left out, the host CPU has no AVX-512 (%s)"
              % host_cpu()["model"], flush=True)
        return None
    before = dict(bitwork.engine_calls)
    got, _ = decode_all(payloads, width, height, digest=True, engine="simd")
    engine_calls = {k: bitwork.engine_calls[k] - before[k] for k in before}
    ok = [d == want for d in got]
    parse_ms = {"scalar": [], "simd": []}
    for engine in ("scalar", "simd", "simd", "scalar"):
        tracing.enable(True)
        tracing.snapshot()
        decode_all(payloads, width, height, digest=False, engine=engine)
        tracing.enable(False)
        parse_ms[engine].append(tracing.snapshot()["gop.parse"]["seconds"]
                                * 1e3 / len(payloads))
    line = dict(card=card, host_cpu=host_cpu(), gops=G,
                parse_threads=bitwork.parse_threads(G), sha1_ok=ok,
                engine_calls=engine_calls,
                gop_parse_ms_per_frame_position=parse_ms)
    say("main_path_simd", **line)
    if not all(ok):
        raise SystemExit("the SIMD token engine's frames differ from the "
                         "manifest SHA-1")
    if engine_calls != {"scalar": 0, "simd": len(payloads)} \
            or line["parse_threads"] < 2:
        raise SystemExit("the SIMD case did not parse every frame position "
                         "with the engine on two or more threads")
    return line


def device_profile(fn):
    """One untraced call of fn() timed with the device drained at both
    ends, then one under torch.profiler: device time by kernel (top 12) and
    the device's busy share of the untraced call's wall time (the
    profiler's own start-up is not counted).  Where the profiler reports no
    device time, says so instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t0 = sync_clock()
    fn()
    wall_ms = (sync_clock() - t0) * 1e3
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
          "loop_filter": (lf_cuda, "launches", "kernel_launches"),
          "encode_kf_frame": (enc_intra_cuda, "launches", "kernel_launches"),
          "encode_inter_frame": (enc_inter_cuda, "launches",
                                 "kernel_launches"),
          "decide_inter_frame": (enc_decide_cuda, "launches",
                                 "kernel_launches"),
          "intra_fixup_frame": (enc_intra_fixup_cuda, "launches",
                                "kernel_launches"),
          "rebase_frame": (rebase_cuda, "launches", "kernel_launches")}


def record_launches(mods):
    """Wrap the ``launch`` of each wrapper module in ``mods`` ({kernel:
    module}) so that every call's kernel launches are recorded.  Returns
    ({kernel: [launches of each call]}, a function that unwraps them)."""
    rec = {k: [] for k in mods}
    saved = {k: m.launch for k, m in mods.items()}

    def wrap(fn, calls):
        def wrapped(*a):
            n = fn(*a)
            calls.append(n)
            return n
        return wrapped

    for k, m in mods.items():
        m.launch = wrap(saved[k], rec[k])

    def undo():
        for k, m in mods.items():
            m.launch = saved[k]
    return rec, undo


def zero_counts():
    for mod, calls, kernels in COUNTS.values():
        setattr(mod, calls, 0)
        setattr(mod, kernels, 0)


def read_counts():
    """({kernel: wrapper calls}, {kernel: kernel launches inside them})."""
    return ({k: getattr(m, c) for k, (m, c, _) in COUNTS.items()},
            {k: getattr(m, n) for k, (m, _, n) in COUNTS.items()})


def interframes(payloads):
    """The interframes among VP8 frames (bit 0 of the frame tag set)."""
    return sum(p[0] & 1 for p in payloads)


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


def persistent_paths(card, payloads, want, width, height):
    """The single-frame path (counters to 0 just before, read just after),
    then the keyframe_encode, inter_encode and fast_encode phases; returns
    their four result lines."""
    zero_counts()
    sf_ok = single_frame_decode(digest=True) == want
    sf_calls, sf_kernels = read_counts()
    rt_ok = state_round_trip(payloads, width, height) == want
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
        lambda: single_frame_decode(digest=False)))
    if not (sf_ok and rt_ok):
        raise SystemExit("single-frame decode differs from the manifest SHA-1")
    if min(sf_calls[k] for k in ("predict_mb_tiles", "intra_frame",
                                 "loop_filter")) <= 0:
        raise SystemExit("the single-frame path did not launch K3, K4 and K5")
    if sf_calls["sixtap_mc"] or sf_calls["wavefront_decode"]:
        raise SystemExit("the single-frame path launched a GOP kernel")
    if sf_calls["predict_mb_tiles"] != interframes(payloads) \
            or sf_calls["intra_frame"] != len(payloads):
        raise SystemExit("the single-frame path made other than one K3 call "
                         "an interframe and one K4 call a frame")
    if sf_kernels["loop_filter"] != sf_calls["loop_filter"]:
        raise SystemExit("K5 did not launch one persistent kernel per call")

    kf = keyframe_encode_phase(card, width, height)
    inter = inter_encode_phase(card, width, height)
    fast = fast_encode_phase(card, width, height,
                             inter["speed"]["rt_qi48"]["ms_per_interframe"])
    return single, kf, inter, fast


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device")
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
    enckernel._load()       # the host patch's intra transforms: no fallback
    say("build", cuda_kernels_s=t_cuda, native_parsers_s=time.perf_counter() - t0,
        ptxas={k: [l for l in v.splitlines()
                   if "registers" in l or "spill" in l or "error" in l]
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
        k2_case("176x144 G=3 frame1", kept["mc"]),
        k1_case("176x144 frame1 interframe", kept["wave_inter"]),
        k1_case("176x144 frame0 key frame", kept["wave_key"]),
    ]

    kept = real_kernel_inputs(payloads, ivf.width, ivf.height, G)
    synthetic = mc_synthetic(16)
    cases = [
        k2_case("720p G=16 frame1, three slots", kept["mc"]),
        k2_case("720p G=2 synthetic extreme MVs", synthetic),
        k1_case("frame1 interframe", kept["wave_inter"], REPEATS),
        k1_case("frame0 key frame", kept["wave_key"], REPEATS),
    ]
    # more (row, frame) warps than the card holds at once: the key frame
    # repeated over enough frames
    res1 = wavefront_cuda.resident(DEV)
    g1 = over_residency_rows(res1, 1) // (ivf.height // 16) + 1
    say("kernels", kernel="wavefront_decode", resident_blocks=res1,
        over_residency_blocks=g1 * (ivf.height // 16))
    cases.append(k1_case("720p G=%d over-residency frame0 key frame" % g1,
                         tiled(kept["wave_key"], g1)))
    # K5 at G=16 on the GOP clip's unfiltered interframe planes (K4's)
    wi = kept["wave_inter"]
    k5_gop = k5_case("720p G=16 GOP frame1 interframe",
                     intra_cuda.intra_frame(*wi[:11]) + (wi[11],), 10)
    del kept, wi

    # the single-frame kernels on what the Decoder hands them at 720p
    sf = single_frame_kernel_inputs(payloads, ivf.width, ivf.height)
    k3 = [k3_case("720p G=1 frame1, three unstacked rasters",
                  sf[("predict_mb_tiles", 1)][0]),
          k3_case("720p G=1 synthetic extreme MVs", mc_single(*synthetic))]
    k4 = [k4_case("frame1 interframe", sf[("intra_frame", 1)][0], REPEATS),
          k4_case("frame0 key frame", sf[("intra_frame", 0)][0], REPEATS)]
    # more (row, frame) blocks than the card holds at once: the key frame
    # repeated over enough frames
    res4 = intra_cuda.resident(DEV)
    g4 = over_residency_rows(res4, 1) // (ivf.height // 16) + 1
    say("kernels", kernel="intra_frame", resident_blocks=res4,
        over_residency_blocks=g4 * (ivf.height // 16))
    k4.append(k4_case("720p G=%d over-residency frame0 key frame" % g4,
                      tiled(sf[("intra_frame", 0)][0], g4)))
    sf_small = single_frame_kernel_inputs([small.frame(0), small.frame(1)],
                                          small.width, small.height)
    k4 += [k4_case("176x144 frame1 interframe",
                   sf_small[("intra_frame", 1)][0]),
           k4_case("176x144 frame0 key frame",
                   sf_small[("intra_frame", 0)][0])]
    k5 = [k5_case("frame1 interframe", sf[("loop_filter", 1)][0], 10),
          k5_case("frame0 key frame", sf[("loop_filter", 0)][0], 10),
          k5_gop]
    # more (row, frame) blocks than the card holds at once: frame 1
    # broadcast over enough levels
    res5 = lf_cuda.resident(DEV)
    g5 = over_residency_rows(res5, 1) // (ivf.height // 16) + 1
    say("kernels", kernel="loop_filter", resident_blocks=res5,
        over_residency_blocks=g5 * (ivf.height // 16))
    k5.append(k5_case("720p G=%d over-residency frame1 broadcast" % g5,
                      k5_tiled(sf[("loop_filter", 1)][0], g5)))
    del sf, sf_small, synthetic

    # K7 on decoded frames: one-pass at two quantizers, two-pass under the
    # default token costs and under the tables after one key frame, at 720p
    # and at 176x144 (a small geometry with odd macroblock counts, 9 x 11)
    big = decoded_frames(CLIP, (0, 3))
    tc_default = torch.from_numpy(token_costs_pm(T.DEFAULT_COEFF_PROBS)).to(DEV)
    first = Encoder(ivf.width, ivf.height, two_pass=True, device=DEV)
    first.encode_with_quantizer(big[0].display(), 32, key_frame=True)
    tc_after = torch.from_numpy(token_costs_pm(
        first.state.probability_tables.coeff_probs)).to(DEV)
    small0 = decoded_frames(SMALL_CLIP, (0,))[0]
    k7 = [k7_case("720p frame0 qi24", kf_args(big[0], 24), 10),
          k7_case("720p frame3 qi24", kf_args(big[3], 24), 10),
          k7_case("720p frame0 qi64", kf_args(big[0], 64), 10),
          k7_case("720p frame3 qi64", kf_args(big[3], 64), 10),
          k7_case("720p frame0 two-pass qi32 default tables",
                  kf_args(big[0], 32, tc_default), 10),
          k7_case("720p frame3 two-pass qi32 tables after one key frame",
                  kf_args(big[3], 32, tc_after), 10),
          k7_case("176x144 frame0 qi48", kf_args(small0, 48)),
          k7_case("176x144 frame0 two-pass qi48 default tables",
                  kf_args(small0, 48, tc_default))]
    # K5 on the encoders' loop-filter search call (8 levels, one frame)
    k5.append(k5_case("720p key frame qi24 search, %d levels broadcast"
                      % LF_CHUNK, k5_search_inputs(big[0], 24), 10))
    # more row blocks than the card holds at once: a narrow, tall frame
    # (one-pass: the two-pass form runs the same schedule, and its plain
    # version would take minutes here)
    res7 = enc_intra_cuda.resident(DEV)
    rows7 = over_residency_rows(res7, 1)
    say("kernels", kernel="encode_kf_frame", resident_blocks=res7,
        resident_blocks_two_pass=enc_intra_cuda.resident(DEV, True),
        over_residency_blocks=rows7)
    tall = [torch.from_numpy(p).to(DEV)
            for p in extreme_motion_planes(47, 176, 16 * rows7, 40)[1]]
    k7.append(k7_case("176x%d over-residency qi48" % (16 * rows7),
                      tuple(tall) + tuple(kf_args(small0, 48)[3:])))
    del big, first, small0, tall

    # K8: 176x144 (frame 1 of the small clip after frame 0 as a key frame)
    # in best, rt and two-pass; 720p frame 1 one-pass best; the fused pair
    # at 720p; seeded extreme motion at 720p
    sm = decoded_frames(SMALL_CLIP, (0, 1))
    big = decoded_frames(CLIP, (0, 1))
    k8 = [k8_case("720p frame1 best qi48",
                  k8_args(big[0], big[1], 48, [48]), REPEATS),
          k8_case("176x144 frame1 best qi48", k8_args(sm[0], sm[1], 48, [48])),
          k8_case("176x144 frame1 rt qi48",
                  k8_args(sm[0], sm[1], 48, [48], "rt")),
          k8_case("176x144 frame1 two-pass qi32",
                  k8_args(sm[0], sm[1], 32, [32], two_pass=True)),
          k8_case("720p frame1 rt pair qi56 -> (40, 72)",
                  k8_args(big[0], big[1], INTER_PAIR_KEY_QI, INTER_PAIR_QIS,
                          "rt"), REPEATS),
          k8_case("720p seeded extreme motion", k8_extreme(44), REPEATS),
          k8_case("720p frame1 rt qi48",
                  k8_args(big[0], big[1], 48, [48], "rt"), REPEATS)]
    del sm, big
    # more (row, quantizer) blocks than the card holds at once: a narrow,
    # tall frame at two quantizers
    res8 = enc_inter_cuda.resident(DEV)
    rows8 = over_residency_rows(res8, len(INTER_PAIR_QIS))
    say("kernels", kernel="encode_inter_frame", resident_blocks=res8,
        over_residency_blocks=rows8 * len(INTER_PAIR_QIS))
    k8.append(k8_case("176x%d over-residency extreme motion pair" % (16 * rows8),
                      k8_extreme(45, 176, 16 * rows8, 40, INTER_PAIR_QIS)))

    # K9 and K10 on what the fast path hands them: 720p frame 1 after
    # frame 0 as a key frame, the pair, a scene cut (frame 0 against frame
    # 5's reconstruction: many intra macroblocks, some adjacent) and 176x144
    sm = decoded_frames(SMALL_CLIP, (0, 1))
    big = decoded_frames(CLIP, (0, 1, 5))
    fast_in = [("720p frame1 qi48", fast_kernel_inputs(big[0], big[1], 48,
                                                       [FAST_QI])),
               ("720p frame1 pair qi56 -> (40, 72)", fast_kernel_inputs(
                   big[0], big[1], FAST_PAIR_KEY_QI, FAST_PAIR_QIS)),
               ("720p scene cut: frame0 against frame5 qi48",
                fast_kernel_inputs(big[5], big[0], 48, [FAST_QI])),
               ("176x144 frame1 qi48", fast_kernel_inputs(sm[0], sm[1], 48,
                                                          [FAST_QI]))]
    k9 = [k9_case(label, a9, REPEATS if label.startswith("720p") else 0)
          for label, (a9, _, _) in fast_in]
    k10 = [k10_case(label, a10, REPEATS if label.startswith("720p") else 0)
           for label, (_, a10, _) in fast_in]
    k3 += [k3_case("%s, LAST broadcast" % label, a3)
           for label, (_, _, a3) in fast_in if label.startswith("720p")]
    del sm, big, fast_in
    res9 = enc_decide_cuda.resident(DEV)
    rows9 = over_residency_rows(res9, len(FAST_PAIR_QIS))
    say("kernels", kernel="decide_inter_frame", resident_blocks=res9,
        over_residency_blocks=rows9 * len(FAST_PAIR_QIS))
    k9.append(k9_case("176x%d over-residency extreme motion pair" % (16 * rows9),
                      k9_extreme(46, 176, 16 * rows9, 40, FAST_PAIR_QIS)))
    res10 = enc_intra_fixup_cuda.resident(DEV)
    rows10 = over_residency_rows(res10, len(FAST_PAIR_QIS))
    say("kernels", kernel="intra_fixup_frame", resident_blocks=res10,
        over_residency_blocks=rows10 * len(FAST_PAIR_QIS))
    k10.append(k10_case("176x%d over-residency scene cut pair" % (16 * rows10),
                        k10_scene_cut(48, 176, 16 * rows10, FAST_PAIR_QIS)))
    # the rebase's residue kernel: rebased frames 4 and 5's arguments at
    # 720p, seeded SPLITMV macroblocks with extreme vectors at qi 0 and 127,
    # every macroblock inter with one vector, every one intra (the longest
    # chain), a 176x144 mix, and a tall mix with more rows than the card
    # holds blocks at once
    rframes = decoded_frames(CLIP, tuple(range(REBASE_FRAMES)))
    rframes = [rframes[k].display() for k in range(REBASE_FRAMES)]
    captured = rebase_kernel_inputs(rframes, ivf.width, ivf.height)
    k11 = [rebase_case("720p rebased frame %d qi%d" % (REBASE_CHUNK + 1 + i,
                                                      REBASE_QI), a, REPEATS)
           for i, a in enumerate(captured)]
    del captured
    k11 += [rebase_case(label, rebase_synthetic(seed, 1280, 720, qi, kind),
                        REPEATS)
            for label, seed, qi, kind in (
                ("720p seeded SPLITMV extreme vectors qi0", 51, 0,
                 "splitmv_extreme"),
                ("720p seeded SPLITMV extreme vectors qi127", 52, 127,
                 "splitmv_extreme"),
                ("720p seeded all inter, whole vectors qi48", 54, 48,
                 "whole"),
                ("720p seeded all intra qi48", 55, 48, "intra"))]
    k11.append(rebase_case("176x144 seeded mix qi48",
                           rebase_synthetic(53, 176, 144, 48, "mixed")))
    res11 = rebase_cuda.resident(DEV)
    rows11 = over_residency_rows(res11, 1)
    say("kernels", kernel="rebase_frame", resident_blocks=res11,
        over_residency_blocks=rows11)
    k11.append(rebase_case("176x%d over-residency seeded mix qi48"
                           % (16 * rows11),
                           rebase_synthetic(56, 176, 16 * rows11, 48,
                                            "mixed")))
    say("kernels", helpers=helper_plain_ms())
    if quick:
        return

    # main path: counters to 0 just before, read just after; every K1 and
    # six-tap call recorded
    k1_calls, undo = record_launches({"wavefront_decode": wavefront_cuda,
                                      "sixtap_mc": sixtap_cuda})
    try:
        zero_counts()
        got, _ = decode_all(payloads, ivf.width, ivf.height, digest=True)
        gop_calls, gop_kernels = read_counts()
    finally:
        undo()
    ok = [d == want for d in got]
    say("main_path", gops=G, frames=len(payloads), width=ivf.width,
        height=ivf.height, sha1_ok=ok, launches=gop_calls,
        kernel_launches=gop_kernels)
    if not all(ok):
        raise SystemExit("decoded frames differ from the manifest SHA-1")
    if gop_calls["sixtap_mc"] <= 0 or gop_calls["wavefront_decode"] <= 0:
        raise SystemExit("the main path did not launch both kernels")
    if any(set(v) != {1} for v in k1_calls.values()):
        raise SystemExit("a K1 or six-tap call of the main path issued other "
                         "than one kernel launch")
    if gop_calls["sixtap_mc"] != interframes(payloads):
        raise SystemExit("the main path made other than one six-tap call "
                         "an interframe")

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
        lambda: decode_all(payloads, ivf.width, ivf.height, digest=False)))
    simd = simd_main_path(card, payloads, ivf.width, ivf.height, want)

    # every K3, K4, K5, K7, K8, K9, K10 and residue-kernel call of the
    # single-frame, encode and rebase paths, and every K1 and six-tap call
    # of the main path: one launch
    per_call, undo = record_launches({"predict_mb_tiles": sixtap_cuda,
                                      "intra_frame": intra_cuda,
                                      "loop_filter": lf_cuda,
                                      "encode_kf_frame": enc_intra_cuda,
                                      "encode_inter_frame": enc_inter_cuda,
                                      "decide_inter_frame": enc_decide_cuda,
                                      "intra_fixup_frame":
                                          enc_intra_fixup_cuda,
                                      "rebase_frame": rebase_cuda})
    try:
        single, kf, inter, fast = persistent_paths(card, payloads, want,
                                                   ivf.width, ivf.height)
        rb = rebase_phase(card, ivf.width, ivf.height, rframes,
                          k11[0]["fetch_ms"])
        xt = xc_tools_phase(card, ivf.width, ivf.height, rframes)
        cl = cluster_phase(card, ivf.width, ivf.height, rframes)
        sal = salsify_phase(card, ivf.width, ivf.height)
        mesh = mesh_phase(card, ivf.width, ivf.height, payloads)
    finally:
        undo()
    per_call.update(k1_calls)
    persistent = {k: {"calls": len(v), "launches_per_call": sorted(set(v))}
                  for k, v in per_call.items()}
    say("persistent_launches", **persistent)
    if any(not v or set(v) != {1} for v in per_call.values()):
        raise SystemExit("a K1, K3, K4, K5, K7, K8, K9, K10, six-tap or "
                         "residue-kernel call of its paths issued other than "
                         "one kernel launch")
    # each kernel's calls on every path it runs on (the cluster's: those
    # of its rebase, in this process)
    paths = (single["launches"], kf["launches"], inter["launches"],
             fast["launches"], fast["host_patch"]["launches"],
             rb["launches"], xt["launches"],
             cl["launches_in_this_process"], sal["launches"],
             mesh["launches"])
    calls_on_paths = {k: sum(line[k] for line in paths)
                      for k in ("predict_mb_tiles", "intra_frame",
                                "loop_filter", "encode_kf_frame",
                                "encode_inter_frame", "decide_inter_frame",
                                "intra_fixup_frame", "rebase_frame")}

    def entry(name, source, replaces, launches, primary, all_cases):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(c["max_abs_err"] for c in all_cases),
                "ms": primary.get("in_place_ms", primary["kernel_ms"]),
                "plain_ms": primary["plain_ms"],
                "bound_ms": primary["bound_ms"], "bound_by": primary["bound_by"],
                "library_ms": None, "library": NO_LIBRARY,
                "measured_on": primary["case"], "cases": all_cases}

    print(json.dumps({"kernels": [
        entry("sixtap_mc", "alfalfa_tpu_torch/csrc/sixtap_mc.cu",
              "alfalfa_tpu/ops/sixtap_pallas.py:269",
              gop_calls["sixtap_mc"], cases[0], cases[:2] + small_cases[:1]),
        entry("wavefront_decode", "alfalfa_tpu_torch/csrc/wavefront.cu",
              "alfalfa_tpu/ops/wavefront_pm.py:432",
              gop_calls["wavefront_decode"], cases[2],
              cases[2:] + small_cases[1:]),
        entry("predict_mb_tiles", "alfalfa_tpu_torch/csrc/sixtap_mc.cu",
              "alfalfa_tpu/ops/sixtap_pallas.py:347",
              calls_on_paths["predict_mb_tiles"], k3[0], k3),
        entry("intra_frame", "alfalfa_tpu_torch/csrc/wavefront.cu",
              "alfalfa_tpu/ops/intra_pallas.py:346",
              calls_on_paths["intra_frame"], k4[0], k4),
        entry("loop_filter", "alfalfa_tpu_torch/csrc/wavefront.cu",
              "alfalfa_tpu/ops/lf_pallas.py:148",
              calls_on_paths["loop_filter"], k5[0], k5),
        entry("encode_kf_frame", "alfalfa_tpu_torch/csrc/enc_intra.cu",
              "alfalfa_tpu/ops/enc_intra_pallas.py:555 (with H1 "
              "enc_transforms_pallas.py and H2 trellis_pallas.py:322 inside)",
              calls_on_paths["encode_kf_frame"], k7[0], k7),
        entry("encode_inter_frame", "alfalfa_tpu_torch/csrc/enc_inter.cu",
              "alfalfa_tpu/ops/enc_inter_pallas.py:1003 (with H1 "
              "enc_transforms_pallas.py and H2 trellis_pallas.py:322 inside)",
              calls_on_paths["encode_inter_frame"], k8[0], k8),
        entry("decide_inter_frame", "alfalfa_tpu_torch/csrc/enc_decide.cu",
              "alfalfa_tpu/ops/enc_decide_pallas.py:249",
              calls_on_paths["decide_inter_frame"], k9[0], k9),
        entry("intra_fixup_frame",
              "alfalfa_tpu_torch/csrc/enc_intra_fixup.cu",
              "alfalfa_tpu/ops/enc_intra_fixup_pallas.py:183 (with H1 "
              "enc_transforms_pallas.py inside)",
              calls_on_paths["intra_fixup_frame"], k10[0], k10),
        entry("rebase_frame", "alfalfa_tpu_torch/csrc/rebase_residues.cu",
              "none: alfalfa_tpu/encoder/reencode_device.py:39 (_fn_core, "
              "XLA around K3 sixtap_pallas.py:347 and H1 "
              "enc_transforms_pallas.py) and alfalfa_tpu/encoder/"
              "reencode.py:23 (_apply_intra_mb, the host loop)",
              calls_on_paths["rebase_frame"], k11[0], k11),
    ]}), flush=True)
    # again, so the end of the log has them
    say("throughput", **throughput)
    say("single_frame", **single)
    say("keyframe_encode", **{k: v for k, v in kf.items()
                              if k != "device_profile"})
    say("inter_encode", **{k: v for k, v in inter.items()
                           if k != "device_profile"})
    say("fast_encode", **{k: v for k, v in fast.items()
                          if k != "device_profile"})
    say("rebase", **{k: v for k, v in rb.items() if k != "device_profile"})
    say("xc_tools", **{k: v for k, v in xt.items() if k != "stage_report"})
    say("cluster", **cl)
    say("salsify", **sal)
    say("mesh", **mesh)
    if simd is not None:
        say("main_path_simd", **simd)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
