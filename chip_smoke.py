#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases
    python3 chip_smoke.py --quick    # env, build, kernels and memory
                                     # checks only (first look at a
                                     # changed kernel)
    python3 chip_smoke.py --only salsify_link,target_size_encode
                                     # env, build and the named paths
                                     # alone (corpus_decode,
                                     # offgrid_encode, target_size_encode,
                                     # salsify, salsify_link): no kernel
                                     # cases, no memory checks

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
clip.  Off the first two fixtures: K1 and K2 on frames 0 and 1 of a G=14
batch of different QCIF clips, K3, K4 and K5 on frames 0 and 1 of the
90x48 clip (3 x 6 macroblocks), and K7, K8, K9, K10, K3 and the residue
kernel on what the encoders hand them at 360x242 (partial macroblocks at
the right and the bottom); K1 and K2 on frames 0 and 1 of the four
feature streams at 170x138 as one G=4 batch and K3 on frame 1 of two of
them (SPLITMV, golden/altref: the authored features off the grid); K7,
K8 (best, rt), K9, K10 and K3 on what the size search's trial encoder
hands them at the 720p mosaic (11 x 20 macroblocks, 320x176).  K1, K4,
K5, K7, K8, K9, K10 and the residue kernel are persistent
(one launch a call, blocks walking rows behind progress flags): each of
their 720p cases runs 10 (K5, K7) or REPEATS (K1, K4, K8, K9, K10, the
residue kernel) times more, every run held to the plain output, since a
race between rows would show only now and then, and each runs once more
with more (row, frame or quantizer) blocks than the card holds at once.
Then memory_checks, the port's memory-safety check on the card
(alfalfa_tpu_torch/tools/poison_check.py with csrc/poison.cu;
compute-sanitizer does not run on the machine with the card): its three
positive controls (a kernel reading a shared word it never wrote, one
reading an element past its input, one writing an element past an output
it is given and one past an output allocated as the wrappers allocate
theirs) must be caught; every case above runs again once under each fill
(0x00, then 0xFF) of every SM's shared memory and of the caching
allocator's free blocks, its arguments copied, and what its wrapper
allocates (ops/alloc.py) carved, between 256-byte guards of the fill,
each run torch.equal to the plain version's output with every guard
intact; tools/sanitize_fuzz.py's 64 corrupted streams (truncations
and byte flips of inter_176x144_q32.ivf) go through a concealing Decoder
on the card (K3, K4, K5) under both fills, each frame's SHA-1 equal to
the CPU decode's (tools/corrupted_streams.json); within MEMORY_CHECK_S.
Then it drives the paths over
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
- corpus_decode: every clip of tests/fixtures/natural_manifest.json and
  the 720p fixture, grouped by size and frame types
  (alfalfa_tpu_torch/tools/corpus.py), each group one BatchedGopDecoder
  batch whose GOPs are different clips (G=14, 5, 4, 4, 2 and three clips
  off the 16-pixel grid at G=1), under the scalar token parser and, where
  the host CPU has AVX-512, the SIMD engine on two or more threads; every
  clip through FilePlayer; the four streams of tools/feature_streams.py
  (SPLITMV, segmentation, golden/altref with sign bias, probability
  updates) through FilePlayer and a G=1 GOP decoder, and together as one
  G=4 batch, frame by frame against FEATURE_SHA1; the same four streams
  at 170x138 (off the grid) through a Decoder, FilePlayer and xc decode,
  and as one G=4 batch under each token engine, frame by frame against
  FEATURE_OFFGRID_SHA1; xc decode of the 360x242 clip to y4m
  (XC_DECODE_Y4M_SHA1: the JAX CLI's bytes);
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
- offgrid_encode: the 8 frames of natural/cut_360x242_q56.ivf (both
  dimensions off the grid, chroma 180x121, a scene cut before frame 4)
  as key frames (qi 24, qi 64, two-pass qi 32, minimum SSIM), as
  interframes (best, rt, two-pass, minimum SSIM, the fused pair), on the
  fast path and its host patch (the stream and the pair) and through xc
  enc -O / enc / enc -r (chunk 0 = frames 0-3, the prediction = frames
  4-7): every frame against OFFGRID_ENCODE_SHA1 (the JAX package's),
  re-decoded to the encoder's minihash, the fast streams in the serial rt
  encoder's RD band, no K10 launch in the host-patch stream;
- target_size_encode: xc enc -F (one target size a frame) over decoded
  frames 0-5 of the 720p fixture and of the 360x242 clip in best, rt and
  rt --fast, each size search binary-searching the quantizer with trial
  encodes of a mosaic of every 4th macroblock (320x176 and 80x64);
  every payload against TARGET_SIZE_SHA1 (the JAX CLI's), re-decoded from
  scratch to the encoder's minihash, within its target unless the search
  took its floor branch (no quantizer's estimate fitting: frame 3 in each
  run); each search's trial encodes (at least three), and the K7, K8, K9
  and K10 calls made inside them;
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
  kernels), xc decode-raw of the 720p fixture and of the 360x242 clip
  (XC_DECODE_RAW_SHA1: the JAX CLI's bytes); then the residue update's
  ms a frame (its upload, the
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
- salsify_link: the same sender and receiver through net/emulation.py's
  EmulatedLink (SALSIFY_LINK_TRACE: an LTE-like trace whose dips bind the
  budget) at 720p, s2 and conventional mode, up to SALSIFY_LINK_FRAMES
  frames sent each: tests/test_net_emulation.py's gates (s2 at least half
  of SALSIFY_LINK_FRAMES received, conventional mode, which skips every
  frame that does not fit, at least half of what it sends; the link's
  deliveries and ACKs counted; in s2, among the sends with a delay from
  the ACKs, smaller frames at a high delay than at a low one, correlation
  below -0.2); in both modes every send-or-skip choice, logged with the
  frame budget it read, follows sender.cc's rule (the largest output that
  fits, else a skip, else after MAX_SKIPPED skips the fail-small output)
  and at least one frame is skipped; in s2 at least one fail-small output
  is sent after MAX_SKIPPED skips; every payload sent reaches its target
  minihash from its advertised source state; then xc run-contest over 12
  frames and the same trace as a mahimahi file, its printed counts;
- mesh: parallel/gop.py's multi-device steps in this one process, on the
  visible cards and on a 4-shard mesh over cuda:0 (four ring hops):
  gop_decode_step on frames 1-4 against the single-frame Decoder's SHA-1s,
  gop_encode_step against one K7 call a chunk, gop_rebase_chain over
  rebase_chain_inputs_from_ivf (4 chunks of 2 frames) against the same
  chain run serially through the rebase's residue update; ms a step and
  a hop.

Each path runs with the launch counts set to 0 just before it and read
just after, and every K1 and six-tap call of the GOP and corpus paths
and every K3, K4, K5, K7, K8, K9, K10 and residue-kernel call of the
single-frame, corpus, encode, off-grid, target-size, rebase, xc tools,
cluster, Salsify, Salsify link and mesh paths is checked to be one
kernel launch (`main_path`,
`persistent_launches`); the last lines are the `kernels` JSON line (one
entry per kernel), the script's total seconds, the card's name and power
limit, and the result line.
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
from types import SimpleNamespace

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
from alfalfa_tpu_torch.encoder.encoder import LF_CHUNK, _pad_raster
from alfalfa_tpu_torch.encoder.trellis import token_costs_pm
from alfalfa_tpu_torch.input.frame_input import FrameInput
from alfalfa_tpu_torch.native import bitwork, enckernel
from alfalfa_tpu_torch.net import Packet
from alfalfa_tpu_torch.net.emulation import EmulatedLink, lte_like_trace
from alfalfa_tpu_torch.ops import enc_batch, enc_decide, enc_decide_cuda, \
    enc_inter, enc_inter_cuda, enc_intra, enc_intra_cuda, enc_intra_fixup, \
    enc_intra_fixup_cuda, enc_transforms, intra_cuda, lf_cuda, rebase, \
    rebase_cuda, sixtap, sixtap_cuda, transforms, trellis, wavefront, \
    wavefront_cuda
from alfalfa_tpu_torch.parallel import gop
from alfalfa_tpu_torch.parallel.cluster import parallel_encode
from alfalfa_tpu_torch.salsify import SalsifyReceiver, SalsifySender
from alfalfa_tpu_torch.salsify.sender import MAX_SKIPPED
from alfalfa_tpu_torch.state import serdes
from alfalfa_tpu_torch.state.decoder_state import Raster
from alfalfa_tpu_torch.tools import corpus, feature_streams, poison_check, \
    sanitize_fuzz
from alfalfa_tpu_torch.util import tracing
from alfalfa_tpu_torch.util.ivf import IVFReader
from alfalfa_tpu_torch.util.ssim import ssim
from alfalfa_tpu_torch.util.y4m import Y4MReader, Y4MWriter

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


# every case of the kernels phase, for memory_checks: (kernel, case, the
# call, its arguments, the plain version's outputs)
MEMORY_CASES = []


def kernel_case(kernel, label, wrapper, plain, args, counts, bound_fn,
                reps=10, repeats=0, check_call=None, **extra):
    """Launch ``wrapper(*args)`` once and hold it against ``plain(*args)``,
    run once and timed; with ``repeats``, run the wrapper that many times
    more, each output held to the plain one; then time the wrapper.
    ``counts`` reads the wrapper's kernel-launch count (as its C entry
    reported it).  The case is kept for memory_checks, which runs
    ``check_call`` (by default the wrapper) on guarded copies of
    ``args``."""
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
    MEMORY_CASES.append((kernel, label, check_call or wrapper, args, refs))
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
    kernel.  ``payloads[f]``: the clip's frame f (every GOP decodes it), or
    a list of n_gops frames, one a GOP (distinct clips)."""
    dec = gop.BatchedGopDecoder(width, height, n_gops, device=DEV)
    kept = {}
    for f in (0, 1):
        batch = payloads[f] if isinstance(payloads[f], list) \
            else [payloads[f]] * n_gops
        key_frame, batch, _flags, _show = dec.parse_frame_batch(batch)
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


def mosaic_trial(key, frame, key_qi=48, **kw):
    """The size estimator's trial encoder and the mosaic planes it encodes
    for the decoded ``frame``: of a fresh encoder (``kw``) on the card, or,
    with a ``key``, of one that has encoded ``key`` as a key frame at
    ``key_qi`` (``frame`` then an interframe)."""
    e = Encoder(frame.display_width, frame.display_height, device=DEV, **kw)
    if key is not None:
        e.encode_with_quantizer(key.display(), key_qi, key_frame=True)
    return e.trial_encoder(frame.display(), key is None)


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


def redecode_ok(pls, mhs, step, width, height):
    """A stream's frames re-decoded by the port's Decoder on the card to
    the encoder's minihash after each; ``step`` payloads follow the first
    at a time (a pair's quantizers: each decoded by a copy of the decoder
    of the first quantizer's stream)."""
    dec = Decoder(width, height, device=DEV)
    dec.decode_frame(pls[0])
    ok = [dec.minihash() == mhs[0]]
    for i in range(1, len(pls), step):
        for j in range(step):
            d = dec.copy() if step > 1 else dec
            d.decode_frame(pls[i + j])
            ok.append(d.minihash() == mhs[i + j])
        if step > 1:
            dec.decode_frame(pls[i])
    return ok


def fast_decode_ok(runs, width, height):
    """Every frame of the runs re-decoded by the port's Decoder on the card
    to its encoder's minihash (the pair: each of its frames by a copy of
    the decoder of the first stream)."""
    return [ok for name, pls, mhs, *_ in runs for ok in redecode_ok(
        pls, mhs, len(FAST_PAIR_QIS) if FAST_RUNS[name][1] else 1, width,
        height)]


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


def serial_rt_reference(frames, width, height, order=FAST_ORDER):
    """The serial rt encoder (K8) on the fast stream's frames (frame 0,
    then ``order``) and quantizer: (payload sizes, luma SSIM of LAST
    against the source after each interframe), the RD-parity baseline."""
    e = Encoder(width, height, quality="rt", device=DEV)
    e.encode_with_quantizer(frames[0], FAST_QI, key_frame=True)
    sizes, quals = [], []
    for k in order:
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


def residue_in_place(orig, refs, words, quant, recon):
    """The residue wrapper on the planes it is given, written in place (the
    memory check's guarded copies); returns residue_call's (output words,
    y, u, v)."""
    return (rebase_cuda.rebase_frame(orig, refs, words, quant, recon),) \
        + tuple(recon)


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
        check_call=residue_in_place, in_place_ms=in_place,
        fetch_ms=fetch_ms(call()),
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


def rebase_setup(frames, width, height, chunk=REBASE_CHUNK, n=REBASE_FRAMES):
    """Chunk 0 (frames 0-2, or up to ``chunk``) and the independent
    prediction chunk (frames 3-5, or ``chunk`` to ``n``), each encoded at
    REBASE_QI by a new Encoder on the card: (chunk 0's exit state as
    .state bytes, the prediction's payloads)."""
    enc0 = Encoder(width, height, device=DEV)
    for k in range(chunk):
        enc0.encode_with_quantizer(frames[k], REBASE_QI)
    encp = Encoder(width, height, device=DEV)
    payloads = [encp.encode_with_quantizer(frames[k], REBASE_QI)
                for k in range(chunk, n)]
    return serdes.save_decoder(enc0.state, enc0.references), payloads


def rebase_run(frames, width, height, state, pred, hashes=False,
               chunk=REBASE_CHUNK, n=REBASE_FRAMES):
    """``reencode`` of frames 3-5 (or ``chunk`` to ``n``) against
    ``state`` (.state bytes) with the parsed prediction ``pred``, by a new
    Encoder on the card: (the FrameSink, seconds of the reencode call,
    device drained at both ends)."""
    enc = Encoder(width, height, device=DEV)
    enc.state, enc.references = serdes.load_decoder(state, device=DEV)
    sink = FrameSink(enc if hashes else None)
    t0 = sync_clock()
    RB.reencode(enc, frames[chunk:n], pred, REBASE_KF_WEIGHT, False, sink)
    return sink, sync_clock() - t0


def rebase_kernel_inputs(frames, width, height, chunk=REBASE_CHUNK,
                         n=REBASE_FRAMES):
    """The residue kernel's arguments for rebased frames 4 and 5 (or every
    residue update of frames ``chunk`` to ``n``), captured from a rebase
    run; the reconstruction planes as the kernel received them."""
    state, payloads = rebase_setup(frames, width, height, chunk, n)
    pred = RB.parse_prediction(payloads, Decoder(width, height, device=DEV))
    kept = []
    real = reencode_device.rebase_frame

    def capture(orig, refs, words, quant, recon):
        kept.append((orig, refs, words, list(quant),
                     [p.clone() for p in recon]))
        return real(orig, refs, words, quant, recon)

    reencode_device.rebase_frame = capture
    try:
        rebase_run(frames, width, height, state, pred, chunk=chunk, n=n)
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


def run_xc(argv, stdin=None, binary=False):
    """The port's xc.main(argv) in this process, on the card: (exit code,
    stdout, stderr, wall ms with the device drained at both ends); with
    ``binary``, stdout as the bytes written to sys.stdout.buffer."""
    import contextlib
    import io
    out, err = io.StringIO(), io.StringIO()
    if binary:
        out = io.TextIOWrapper(io.BytesIO(), write_through=True)
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
    return (rc or 0, out.buffer.getvalue() if binary else out.getvalue(),
            err.getvalue(), (sync_clock() - t0) * 1e3)


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

    def step(name, argv, stdin=None, binary=False):
        rc, out, err, wall = run_xc(argv, stdin, binary)
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
    # decode-raw: the raw planes of every shown frame on stdout
    raw_ok = {}
    for name, path in (("720p", CLIP), ("360x242", OFFGRID_CLIP)):
        rc, raw, _ = step("decode-raw " + name, ["decode-raw", path],
                          binary=True)
        raw_ok[name] = rc == 0 and \
            hashlib.sha1(raw).hexdigest() == XC_DECODE_RAW_SHA1[name]
    gates["decode-raw"] = all(raw_ok.values())

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


def salsify_run(frames, width, height, mode, drop=None, link=None,
                max_frames=None):
    """The port's SalsifySender and SalsifyReceiver on loopback UDP in this
    process, both on the card, both sockets on port 0; with ``link``
    (EmulatedLink's keyword arguments) the sender sends to an EmulatedLink
    in front of the receiver, which carries the ACKs back.  Each frame
    sent is logged with its source state (copied: prune_encoders drops old
    encoders), payload and target minihash; the sender's log lines are
    kept, and each handle_encodes_done call with outputs is logged with
    the frame budget it read, the outputs' sizes and jobs, the skip count
    before it and the size it sent (None: skipped); the receiver's decode
    calls are timed with the device drained.  The sender stops after
    ``max_frames`` frames sent (default: all of ``frames``) or at the end
    of ``frames``.  Returns (sender, receiver, received rasters, the log,
    decode ms, frames grabbed, the sender's log lines, the link's counts
    or None, the choices)."""
    received, decode_ms, log, lines, choices = [], [], [], [], []
    max_frames = max_frames or len(frames)
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
    port = receiver.socket.getsockname()[1]
    relay = None
    if link is not None:
        relay = EmulatedLink(0, port, **link).start()
        port = relay.listen_port
    source = RepeatedFrames(frames, width, height)
    sender = SalsifySender("127.0.0.1", port, 1337, source, mode=mode,
                           drop_frames_while_busy=False, device=DEV)
    sender._log = lines.append
    send = sender._send_output

    def logged(output):
        src = sender.encoders[output.source_minihash]
        log.append((output.source_minihash, src.state.copy(),
                    src.references.copy(), bytes(output.frame),
                    output.encoder.minihash(), output.job_name,
                    output.y_ac_qi))
        return send(output)
    sender._send_output = logged
    handle = sender.handle_encodes_done

    def chosen():
        outputs, budget = sender._pending, sender.frame_budget()
        skipped, sent = sender.skipped_count, len(sender.sent_log)
        result = handle()
        if outputs:
            choices.append(dict(
                budget=budget, sizes=[len(o.frame) for o in outputs],
                jobs=[o.job_name for o in outputs], skipped=skipped,
                sent=sender.sent_log[-1][1] if len(sender.sent_log) > sent
                else None))
        return result
    sender.handle_encodes_done = chosen
    try:
        sender.run(max_frames=max_frames)
        # an encode still running for the frame after the last one sent
        # finishes before the sender closes
        deadline = time.monotonic() + 10
        while sender._pending == [] and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.05)
        # every frame sent is displayed but one that lost its fragment 0
        # (its prefix is empty), or the receiver stops at ``expect``; over
        # the link, until its queue has drained
        shown = sender.frames_sent - sum(f == 0 for _, f in dropped)
        deadline = time.monotonic() + (30 if relay is None else
                                       SALSIFY_LINK_DRAIN_S)
        while rt.is_alive() and len(received) < shown \
                and time.monotonic() < deadline:
            rt.join(0.1)
    finally:
        sender.close()
        receiver.close()
        rt.join(5)
        if relay is not None:
            relay.close()
    return (sender, receiver, received, log, decode_ms, source.i, lines,
            None if relay is None else dict(relay.stats), choices)


def wrong_choices(choices):
    """The logged handle_encodes_done calls whose choice breaks
    sender.cc:565-590's rule for the budget read: the largest output that
    fits is sent; when none fits the frame is skipped, but after
    MAX_SKIPPED skips a fail-small output is sent all the same."""
    wrong = []
    for i, c in enumerate(choices):
        fits = [n for n in c["sizes"] if n <= c["budget"]]
        if fits:
            want = max(fits)
        elif c["skipped"] >= MAX_SKIPPED and c["jobs"][-1] == "fail-small":
            want = c["sizes"][-1]
        else:
            want = None
        if c["sent"] != want:
            wrong.append(i)
    return wrong


def payloads_reach(log, width, height):
    """Each logged payload, decoded from its advertised source state by a
    fresh Decoder on the card: whether it reaches its target minihash."""
    reaches = []
    for _src, state, refs, payload, target, _job, _q in log:
        d = Decoder(width, height, state=state.copy(), references=refs,
                    device=DEV)
        d.decode_frame(payload)
        reaches.append(d.minihash() == target)
    return reaches


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
    for name, (snd, rcv, received, log, dec_ms, grabbed, *_) in runs.items():
        reaches = payloads_reach(log, width, height)
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


# salsify_link: the sender and the receiver through an EmulatedLink at
# 720p (decoded frames 0-5 repeated), on an LTE-like trace whose windows
# alternate between SALSIFY_LINK_TRACE's high_pps and low_pps delivery
# opportunities (one MTU each) per 100 ms; the high windows carry about
# twice the mean s2 frame that the loopback run sends, the dips about a
# tenth of it, so the budget binds in the dips only.  s2 and conventional
# mode each send up to SALSIFY_LINK_FRAMES frames of twice as many (a
# skipped frame is grabbed, not sent); then xc run-contest over
# SALSIFY_CONTEST_FRAMES frames and the same trace as a mahimahi file.
SALSIFY_LINK_TRACE = dict(ms_total=6000, period_ms=3000, high_pps=245,
                          low_pps=12)
SALSIFY_LINK_DELAY_MS, SALSIFY_LINK_QUEUE = 20, 512
SALSIFY_LINK_FRAMES, SALSIFY_CONTEST_FRAMES = 40, 12
SALSIFY_LINK_DRAIN_S = 3.0


def adaptation(sent_log):
    """tests/test_net_emulation.py's adaptation numbers over the sends
    that had a delay from the ACKs: (count, mean bytes at a delay above
    the median, mean bytes at or below it, the size/delay correlation)."""
    log = [(size, delay) for _, size, delay, _, _ in sent_log
           if delay is not None]
    if len(log) < 3:
        return len(log), None, None, None
    sizes = np.array([v for v, _ in log], float)
    delays = np.array([d for _, d in log], float)
    hi = delays > np.median(delays)
    if not hi.any() or hi.all():
        return len(log), None, None, None
    return (len(log), float(sizes[hi].mean()), float(sizes[~hi].mean()),
            float(np.corrcoef(sizes, delays)[0, 1]))


def salsify_link_phase(card, width, height):
    """The salsify_link phase (see the module docstring); returns its
    result line."""
    rasters = decoded_frames(CLIP, tuple(range(6)))
    n = SALSIFY_LINK_FRAMES
    frames = [rasters[k % 6].display() for k in range(2 * n)]
    link = dict(trace_ms=lte_like_trace(**SALSIFY_LINK_TRACE),
                delay_ms=SALSIFY_LINK_DELAY_MS,
                queue_limit=SALSIFY_LINK_QUEUE)
    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    y4m = os.path.join(work, "contest.y4m")
    trace = os.path.join(work, "contest.trace")
    write_y4m(y4m, frames[:SALSIFY_CONTEST_FRAMES], width, height)
    with open(trace, "w") as fh:
        fh.write("".join("%d\n" % t for t in link["trace_ms"]))
    # the link path: counters to 0 just before, read just after
    zero_counts()
    t0 = time.perf_counter()
    runs = {mode: salsify_run(frames, width, height, mode, link=link,
                              max_frames=n)
            for mode in ("s2", "conventional")}
    rc, out, err, contest_ms = run_xc(
        ["run-contest", y4m, "--device", str(DEV), "--frames",
         str(SALSIFY_CONTEST_FRAMES), "--trace", trace, "--delay",
         str(SALSIFY_LINK_DELAY_MS), "--queue", str(SALSIFY_LINK_QUEUE),
         "--idle", "5"])
    wall = time.perf_counter() - t0
    calls, kernels = read_counts()      # every thread joined
    line = dict(card=card, width=width, height=height, frames=n,
                trace=SALSIFY_LINK_TRACE, delay_ms=SALSIFY_LINK_DELAY_MS,
                queue_limit=SALSIFY_LINK_QUEUE, runs_wall_s=wall,
                launches=calls, kernel_launches=kernels, runs={})
    ok = {}
    for mode, (snd, rcv, received, log, dec_ms, grabbed, lines, stats,
               choices) in runs.items():
        reaches = payloads_reach(log, width, height)
        count, hi_mean, lo_mean, corr = adaptation(snd.sent_log)
        sizes = [e[1] for e in snd.sent_log]
        enc_ms = [e[4] for e in snd.sent_log]
        skips = sum(l.startswith("skipping frame") for l in lines)
        forced = sum(l.startswith("too many skips") for l in lines)
        wrong = wrong_choices(choices)
        r = dict(frames_grabbed=grabbed, frames_sent=snd.frames_sent,
                 frames_received=len(received), skipped=skips,
                 fail_small_after_skips=forced, link=stats,
                 delay_informed_sends=count,
                 mean_bytes_high_delay=hi_mean, mean_bytes_low_delay=lo_mean,
                 size_delay_correlation=corr,
                 choices=len(choices), wrong_choices=wrong,
                 budgets=[c["budget"] for c in choices],
                 payloads_reach_target=all(reaches) and bool(reaches),
                 jobs=[e[5] for e in log], quantizers=[e[6] for e in log],
                 bytes=sizes,
                 delays_us=[e[2] for e in snd.sent_log],
                 bytes_per_frame_mean=float(np.mean(sizes)) if sizes else None,
                 encode_ms_p50=pct(enc_ms[1:], 50),
                 encode_ms_p95=pct(enc_ms[1:], 95),
                 decode_ms_p50=pct(dec_ms, 50), decode_ms_p95=pct(dec_ms, 95))
        # s2 must deliver half of the n frames, as in
        # tests/test_net_emulation.py; conventional mode skips every frame
        # its one output does not fit, and moves its quantizer once a
        # second, so how many of the 2n it sends depends on the timing
        # (14-33 of 80 on the card): half of those it sends must arrive
        arrive = n if mode == "s2" else max(2, snd.frames_sent)
        survives = (len(received) >= arrive // 2 and stats["delivered"] > 0
                    and stats["acks"] > 0 and r["payloads_reach_target"])
        adapts = (count >= 20 and hi_mean is not None and hi_mean < lo_mean
                  and corr < -0.2)
        # every choice follows the rule for the budget it read, one for
        # each frame sent or skipped, and the budget bound (a skip)
        chooses = (not wrong and len(choices) == snd.frames_sent + skips
                   and skips >= 1)
        r["gates"] = dict(survives=survives, chooses=chooses,
                          adapts=adapts, fail_small=forced >= 1)
        # conventional mode sends one output a frame, never a fail-small
        # one, and its quantizer follows the rate, not the delay
        ok[mode] = survives and chooses if mode == "conventional" else \
            all(r["gates"].values())
        line["runs"][mode] = r
    sent = [l for l in out.splitlines() if l.startswith("sent ")]
    contest = dict(rc=rc, wall_ms=contest_ms, output=out.splitlines()[-3:],
                   stderr_tail=err[-300:])
    if sent:
        contest["sent"] = int(sent[0].split()[1])
        contest["received"] = int(sent[0].split("received ")[1].split(",")[0])
    ok["run_contest"] = (rc == 0 and contest.get("sent", 0) >= 1
                         and contest.get("received", 0) >= 1
                         and "link: {" in out)
    line["run_contest"] = contest
    line["gates_ok"] = ok
    say("salsify_link", **line)
    if not all(ok.values()):
        raise SystemExit("a Salsify run over the emulated link failed its "
                         "gates: %s" % {k: line["runs"].get(k, {}).get(
                             "gates", contest) for k, v in ok.items()
                             if not v})
    for k in ("predict_mb_tiles", "intra_frame", "loop_filter",
              "encode_kf_frame", "decide_inter_frame", "intra_fixup_frame"):
        if calls[k] <= 0 or kernels[k] != calls[k]:
            raise SystemExit("the Salsify link path did not launch %s, one "
                             "launch a call" % k)
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


# ------------------------------------------- the corpus, and off the grid

# corpus_decode: FEATURE_SHA1, the SHA-1 of each frame of the four streams
# of alfalfa_tpu_torch/tools/feature_streams.py (the bytes of
# tests/gen_feature_streams.py) as the JAX package's FilePlayer decodes
# them; XC_DECODE_Y4M_SHA1, the SHA-1 of the y4m file that the JAX
# package's xc decode writes of natural/cut_360x242_q56.ivf (360x242: the
# chroma planes have 121 rows).  Computed once on a CPU host;
# tests/test_torch_corpus.py recomputes them (-m slow).
FEATURE_SHA1 = {
    "feat_splitmv.ivf": [
        "b5a519c8a276d3cc62f1c1721372e80b5c742df2",
        "11a000cdccc861c27acd2372c2703efb1440e728",
        "ff0e7a72eb7f29da37b6b4273a0cdd56bbe7a1b8",
        "55fbe6fc45ce0861f41aac85119a99181a5dabb4"],
    "feat_segmentation.ivf": [
        "ca2b4cb61bdf9b1c336e864a5cee3ab70af24e4a",
        "e4d97c5740c24e3b2849615733c19f9a6a18b611",
        "ef6a126506847e9c4fbe756890445a96e7aad04b",
        "6fd67cf54de4b2991658ad35c2ff8866e7bfc3ed"],
    "feat_goldalt.ivf": [
        "08cacb6ab2f47f41a07fbf6dfb05654be7868440",
        "fde1d4f463832c54ba6063d8a8ed8bac55c00891",
        "ed744cc937a8adbabf7b057d6d3e1cbd5fcd0f28",
        "554e41d2f15d8c11af30b528328e183740ee4577",
        "bc6847585e99026fe4ece35d4f8fbde077570420",
        "0d59b9854b4889e4abbc7a1c459555eead02c097"],
    "feat_probs.ivf": [
        "c9a057df3724e86c28bad23408cef88590de7d34",
        "a380bd4b10128d534637823c3828d92c02abbcc6",
        "f2326510f4e4487b6be90af8ef0caf313a8594d5",
        "39bd6f0835053e8661afcf711d5cf4a67f608dcd",
        "98748f37d223694f7be0227511a2476339b881d8"],
}
XC_DECODE_Y4M_SHA1 = "c74caf4f0b48c6851e111ee5b4f17cf2e595c1a8"
# XC_DECODE_RAW_SHA1: the SHA-1 of what the JAX package's xc decode-raw
# writes of the 720p fixture and of natural/cut_360x242_q56.ivf (the raw
# planes of every shown frame; the manifests' yuv_sha1 too).  Computed
# once on a CPU host; tests/test_torch_decoder.py recomputes them (-m
# slow).
XC_DECODE_RAW_SHA1 = {"720p": "857b9582bd2da63a29e27ecbef2dccdf02d17204",
                      "360x242": "b08992cbc00034f1c7097270a5593fe30a538982"}
# FEATURE_OFFGRID_SHA1: the same for the four streams at
# feature_streams.OFFGRID_SIZE, 170x138 (11 x 9 macroblocks, the last
# column and row 10 pixels: vectors clamped and counted on the rounded-up
# grid, references read past the frame's edge), the bytes the port's
# generator writes (its key frames from the port's encoder).  Computed
# once on a CPU host; tests/test_torch_corpus.py recomputes them (-m
# slow).
FEATURE_OFFGRID_SHA1 = {
    "feat_splitmv.ivf": [
        "d727572c50fa224cd8c81290c2f1667cc8383a65",
        "8a96e960e6a4fc92ed183e65ecc1cf54f9fa1984",
        "08b14e22868b8a8785664df36d861d3e4be3ce91",
        "813752a5dedba111f45ae9cf0a0ece0d0f69c885"],
    "feat_segmentation.ivf": [
        "1ddb2028adeae6f639e7f2a7a965816a6bf82cac",
        "82c163e3addc3db4f46f4ba7258f021498592eb4",
        "649f8a90e00b0398744aee5898f26374c6ea994d",
        "3264f9e2138e4ec7e2d5136b7125f83cc524666a"],
    "feat_goldalt.ivf": [
        "6b676d1e8c8f8af25812af8364a33172d33881ce",
        "b8604105b5c1bcea621edde62430c6889a4bad15",
        "4261291263b01d505ac74351b10c359911add6fa",
        "7c0ae04928db4bb64d2769a8a438d1344225c051",
        "270affbae0f6139947ad97f1f7b60165bd2fa3d4",
        "a461ea60a8c3b60a7c95c3fd8e1ec7cf3ccc1736"],
    "feat_probs.ivf": [
        "a18827c0bf8b3ee0755a878bc2434485cb879932",
        "5eac7b3c2d8ddf40df16b2a9a4536e2d6f34b5e9",
        "bbdd7ce88464796d81daa0fda632c009483468ea",
        "e273bec4e4de77a08dc434c0fe3f20c7d0c2a760",
        "dafccefde0cfc949b2e9ec7421c6197c5ef25c5a"],
}
# the 720p fixture beside the natural corpus's three 720p clips (one batch)
CORPUS_EXTRA = ("inter_1280x720_q48.ivf",)
# the four feature streams in one batch: their first frames (the shortest
# has 4)
FEATURE_BATCH_FRAMES = 4
# the corpus's file with no frame, and no manifest entry
EMPTY_CLIP = "pan_82x48_q40.ivf"
OFFGRID_CLIP = os.path.join(REPO, "tests", "fixtures", "natural",
                            "cut_360x242_q56.ivf")
# the 3 x 6 macroblock clip: the single-frame kernels' cases
TINY_CLIP = os.path.join(REPO, "tests", "fixtures", "natural",
                         "pan_90x48_q40.ivf")


def corpus_batches(groups, engines):
    """Each group of tools/corpus.py as one BatchedGopDecoder batch on the
    card, every GOP a different clip, under each token engine: one dict a
    batch (its GOPs' SHA-1 against their clips', the parse threads, each
    engine's calls, wall seconds)."""
    out = []
    for engine in engines:
        for g in groups:
            before = dict(bitwork.engine_calls)
            t0 = sync_clock()
            got = corpus.decode_batch(g, DEV, engine)
            out.append(dict(
                engine=engine, width=g.width, height=g.height,
                gops=len(g.clips), frames=len(g.pattern),
                parse_threads=bitwork.parse_threads(len(g.clips)),
                engine_calls={k: bitwork.engine_calls[k] - before[k]
                              for k in before},
                seconds=sync_clock() - t0, clips=[c.name for c in g.clips],
                sha1_ok=[a == c.yuv_sha1 for a, c in zip(got, g.clips)]))
    return out


def feature_decodes(work):
    """tools/feature_streams.py's four streams (key frames encoded on the
    card) through FilePlayer and a G=1 GOP decoder each, then the four as
    one G=4 batch over their first FEATURE_BATCH_FRAMES frames: each
    frame's SHA-1 against FEATURE_SHA1.  Returns ({stream: {"frames",
    "file_player_ok", "gop_ok"}}, {stream: batch ok}, frames decoded)."""
    paths = feature_streams.write_all(work, device=DEV)
    res, clips, n_frames = {}, [], 0
    for name, path in paths.items():
        one = corpus.alone(path)
        clips += one.clips
        want = FEATURE_SHA1[name]
        res[name] = dict(
            frames=len(one.pattern),
            file_player_ok=corpus.play(path, DEV, per_frame=True) == want,
            gop_ok=corpus.decode_batch(one, DEV, per_frame=True)[0] == want)
        n_frames += 2 * len(one.pattern)
    n = FEATURE_BATCH_FRAMES
    patterns = {corpus.frame_pattern(c.payloads[:n]) for c in clips}
    if len(patterns) != 1:
        raise SystemExit("the feature streams' first %d frames differ in "
                         "type: no batch" % n)
    batch = corpus.Group(feature_streams.W, feature_streams.H,
                         patterns.pop(), clips)
    got = corpus.decode_batch(batch, DEV, frames=n, per_frame=True)
    return res, {c.name: g == FEATURE_SHA1[c.name][:n]
                 for c, g in zip(clips, got)}, n_frames + n * len(clips)


def y4m_frame_sha1(path):
    """Each frame's SHA-1 in a y4m file (its three planes, as
    Raster.dump_bytes lays them out)."""
    return [hashlib.sha1(b"".join(p.tobytes() for p in f)).hexdigest()
            for f in Y4MReader(path)]


def offgrid_feature_decodes(work, engines):
    """tools/feature_streams.py's four streams at OFFGRID_SIZE (key frames
    encoded on the card) through a Decoder, FilePlayer and xc decode, and,
    over their first FEATURE_BATCH_FRAMES frames, as one G=4
    BatchedGopDecoder batch under each token engine: each frame's SHA-1
    against FEATURE_OFFGRID_SHA1.  Returns ({stream: {path: ok}}, {engine:
    {stream: ok}}, frames decoded)."""
    out = os.path.join(work, "offgrid_features")
    os.makedirs(out, exist_ok=True)
    size = feature_streams.OFFGRID_SIZE
    paths = feature_streams.write_all(out, device=DEV, size=size)
    res, clips, n_frames = {}, [], 0
    for name, path in paths.items():
        want = FEATURE_OFFGRID_SHA1[name]
        one = corpus.alone(path)
        clips += one.clips
        dec, shown = Decoder(*size, device=DEV), []
        for p in one.clips[0].payloads:
            is_shown, raster = dec.decode_frame(p)
            if is_shown:
                shown.append(hashlib.sha1(raster.dump_bytes()).hexdigest())
        y4m = path[:-len(".ivf")] + ".y4m"
        rc = run_xc(["decode", path, y4m])[0]
        res[name] = dict(
            frames=len(one.pattern), decoder_ok=shown == want,
            file_player_ok=corpus.play(path, DEV, per_frame=True) == want,
            xc_decode_ok=rc == 0 and y4m_frame_sha1(y4m) == want)
        n_frames += 3 * len(one.pattern)
    n = FEATURE_BATCH_FRAMES
    batch = corpus.Group(size[0], size[1],
                         corpus.frame_pattern(clips[0].payloads[:n]), clips)
    batches = {}
    for engine in engines:
        got = corpus.decode_batch(batch, DEV, engine, frames=n,
                                  per_frame=True)
        batches[engine] = {c.name: g == FEATURE_OFFGRID_SHA1[c.name][:n]
                           for c, g in zip(clips, got)}
        n_frames += n * len(clips)
    return res, batches, n_frames


def corpus_decode_phase(card):
    """The corpus_decode phase (see the module docstring); returns its
    result line."""
    t0 = time.perf_counter()
    work = os.path.join(REPO, "build", "chip_smoke", "corpus")
    os.makedirs(work, exist_ok=True)
    engines = ["scalar"]
    if bitwork.simd_supported():
        engines.append("simd")
    else:
        print("corpus_decode: the SIMD engine's batches left out, the host "
              "CPU has no AVX-512 (%s)" % host_cpu()["model"], flush=True)
    print("corpus_decode: natural/%s holds no frame and has no manifest "
          "entry, so no batch takes it" % EMPTY_CLIP, flush=True)
    groups = corpus.groups(CORPUS_EXTRA)
    clips = [c for g in groups for c in g.clips]

    # the corpus path: counters to 0 just before, read just after
    zero_counts()
    batches = corpus_batches(groups, engines)
    players = {c.name: corpus.play(c.path, DEV) == c.yuv_sha1 for c in clips}
    features, feature_batch, feature_frames = feature_decodes(work)
    og_features, og_batches, og_frames = offgrid_feature_decodes(work,
                                                                engines)
    y4m = os.path.join(work, "cut_360x242.y4m")
    rc = run_xc(["decode", OFFGRID_CLIP, y4m])[0]
    with open(y4m, "rb") as fh:
        y4m_ok = rc == 0 and \
            hashlib.sha1(fh.read()).hexdigest() == XC_DECODE_Y4M_SHA1
    calls, kernels = read_counts()
    frames = (sum(b["gops"] * b["frames"] for b in batches)
              + sum(len(c.payloads) for c in clips) + feature_frames
              + og_frames
              + len(IVFReader(OFFGRID_CLIP)))
    line = dict(
        card=card, clips=len(clips), engines=engines,
        batches=len(batches), frames_decoded=frames,
        seconds=time.perf_counter() - t0,
        batch_sha1_ok={"%s %dx%d G=%d" % (b["engine"], b["width"],
                                          b["height"], b["gops"]):
                       all(b["sha1_ok"]) for b in batches},
        file_player_sha1_ok=all(players.values()),
        feature_streams=features, feature_batch_sha1_ok=feature_batch,
        offgrid_feature_streams=og_features,
        offgrid_feature_batch_sha1_ok=og_batches,
        xc_decode_y4m_ok=y4m_ok, launches=calls, kernel_launches=kernels,
        batch_detail=batches)
    say("corpus_decode", **line)
    bad = [(b["engine"], n) for b in batches
           for n, ok in zip(b["clips"], b["sha1_ok"]) if not ok]
    if bad:
        raise SystemExit("distinct GOPs in one batch differ from their "
                         "clips' SHA-1: %s" % bad)
    for b in batches:
        if b["engine"] == "simd" and (
                b["engine_calls"] != {"scalar": 0, "simd": b["frames"]}
                or (b["gops"] > 1 and b["parse_threads"] < 2)):
            raise SystemExit("the SIMD engine did not parse every frame "
                             "position of the %dx%d G=%d batch on two or "
                             "more threads" % (b["width"], b["height"],
                                               b["gops"]))
    if not all(players.values()):
        raise SystemExit("FilePlayer differs from the manifest: %s"
                         % sorted(n for n, ok in players.items() if not ok))
    if not all(v["file_player_ok"] and v["gop_ok"]
               for v in features.values()) or not all(feature_batch.values()):
        raise SystemExit("a feature stream's frames differ from "
                         "FEATURE_SHA1")
    if not all(all(v.values()) for v in og_batches.values()) or not all(
            ok for v in og_features.values() for k, ok in v.items()
            if k != "frames"):
        raise SystemExit("a feature stream off the grid differs from "
                         "FEATURE_OFFGRID_SHA1: %s %s"
                         % (og_features, og_batches))
    if not y4m_ok:
        raise SystemExit("xc decode's y4m of %s differs from the JAX CLI's"
                         % os.path.basename(OFFGRID_CLIP))
    gop_kernels = ("sixtap_mc", "wavefront_decode", "predict_mb_tiles",
                   "intra_frame", "loop_filter")
    if any(calls[k] <= 0 or kernels[k] != calls[k] for k in gop_kernels):
        raise SystemExit("the corpus path did not launch K1, K2, K3, K4 and "
                         "K5, each one launch a call")
    return line


# offgrid_encode: SHA-1 of each frame the JAX package makes of the 8
# frames of natural/cut_360x242_q56.ivf (both dimensions off the 16-pixel
# grid, chroma 180x121, a scene cut before frame 4) as its FilePlayer
# decodes them (they meet the natural manifest):
# - "kf_*": its host encoder (Encoder(device_encode=False)), a new one per
#   mode of KF_ENCODE_MODES, encodes frames 0 and 4 as key frames in
#   sequence; "kf_min_ssim_0.90_frame0" is encode_with_minimum_ssim(frame
#   0, KF_MIN_SSIM) in a new one-pass encoder;
# - "inter_*": a new host encoder per mode of INTER_ENCODE_MODES, and
#   "inter_min_ssim" (encode_with_minimum_ssim at INTER_MIN_SSIM), encodes
#   frame 0 as a key frame and frames 1-4 as interframes;
#   "inter_pair_*": a key frame at INTER_PAIR_KEY_QI in an rt encoder,
#   then frame 1 at each of INTER_PAIR_QIS in a fork of it;
# - "fast_*": its fast path (ALFALFA_FAST_INTER=1), a key frame at FAST_QI
#   on the host, then frames 1-7; "fast_pair_*" a key frame at
#   FAST_PAIR_KEY_QI, then frames 1-4 through
#   encode_interframe_fast_multiqp at FAST_PAIR_QIS, on with the first
#   quantizer's fork; "patch_bpred*": the same two under
#   ALFALFA_FAST_FIXUP=0 ALFALFA_FAST_BPRED=1 (the host patch);
# - "rebase_*": chunk 0 (frames 0-3) and the prediction chunk (frames 4-7)
#   each by a new host encoder at REBASE_QI, then its host reencode of
#   the prediction onto chunk 0's exit state at REBASE_KF_WEIGHT.
# Computed once on a CPU host; tests/test_torch_corpus.py recomputes them
# (-m slow).
OFFGRID_KF_FRAMES = (0, 4)
OFFGRID_INTER_FRAMES = 5        # a key frame, then interframes 1-4
OFFGRID_FRAMES = 8              # the fast stream: a key frame, then 1-7
OFFGRID_PAIR_FRAMES = 4         # the fast pairs: frames 1-4
OFFGRID_CHUNK = 4               # the rebase: chunk 0 = frames 0-3
OFFGRID_RUNS = (tuple("kf_" + m[0] for m in KF_ENCODE_MODES)
                + ("kf_min_ssim",)
                + tuple("inter_" + m[0] for m in INTER_ENCODE_MODES)
                + ("inter_min_ssim", "inter_pair") + tuple(FAST_RUNS))
OFFGRID_ENCODE_SHA1 = {
    "kf_qi24_frame0": "9dbb5403949f877ea1b446284a1527f852518232",
    "kf_qi24_frame4": "cced06d76adcf2a9733d6817f3a36864b0409aef",
    "kf_qi64_frame0": "a2032c32617d9d51d67e32e0c22aeab236656fe9",
    "kf_qi64_frame4": "2cf984878c8e04517ebff80d7a34c40e23fe6b6e",
    "kf_qi32_two_pass_frame0": "8542670c020889fcfb81710aa7e923330cd8e9b5",
    "kf_qi32_two_pass_frame4": "73bc64adc9dfb4c0bd5f2769f8b2257df88a57df",
    "kf_min_ssim_0.90_frame0": "42874d5ba7f2da6c21ac3dc78cd5433687088634",
    "inter_best_qi48_frame0": "47506fa4b8259fab1f0e4321176e253ea430f465",
    "inter_best_qi48_frame1": "5a43f1834ae393854f1604eea366983c83f24aad",
    "inter_best_qi48_frame2": "7cb1fe690e3d384bf7238171762ecd75d7d6861b",
    "inter_best_qi48_frame3": "fefdc1f46300c2f640bd6b9bf00f2a850c9d52f1",
    "inter_best_qi48_frame4": "6bd0e532bbced8b56935c8f951d7144fa625c0db",
    "inter_rt_qi48_frame0": "47506fa4b8259fab1f0e4321176e253ea430f465",
    "inter_rt_qi48_frame1": "6b705ae93411c44c9154c71bd28d43af157eeb21",
    "inter_rt_qi48_frame2": "132cb83582e18d5f56eddfc936b5d5582a814cf2",
    "inter_rt_qi48_frame3": "8447df2fa074cc5344e68b51c764ea03416a8671",
    "inter_rt_qi48_frame4": "6d959ec423de43f393413414a26c00bc8fcc6860",
    "inter_best_qi32_two_pass_frame0": "8542670c020889fcfb81710aa7e923330cd8e9b5",
    "inter_best_qi32_two_pass_frame1": "027242e9621276ded1a141d9fbb0364d9feb8925",
    "inter_best_qi32_two_pass_frame2": "37f060cb664fda3f393b6840713d4112477399b3",
    "inter_best_qi32_two_pass_frame3": "f15223a4f7947c2042a14af45f8fdb6b6c1df097",
    "inter_best_qi32_two_pass_frame4": "421013b90ffebd16b73725850e9671159bc71b79",
    "inter_min_ssim_0.90_frame0": "42874d5ba7f2da6c21ac3dc78cd5433687088634",
    "inter_min_ssim_0.90_frame1": "5fac90527b5c09c5248689e6c317a6b4631f96a6",
    "inter_min_ssim_0.90_frame2": "8eb6f01a0bd9cbad72b10c4d28a1c9f54c036ace",
    "inter_min_ssim_0.90_frame3": "dd570f3053274cd3b096247d8ef9c6223047bb88",
    "inter_min_ssim_0.90_frame4": "2e3961f1c7317569dd651cea575827979aaeb8b0",
    "inter_pair_key_qi56_frame0": "3dbd2666bb6b529b7d0c1674375f01c3e9db35c3",
    "inter_pair_qi40_frame1": "18d46a879f28db8db65bb1dae7529e06a1b16c76",
    "inter_pair_qi72_frame1": "be0d74bc8d7014f2a9c2bff197c2040f96239b73",
    "fast_qi48_frame0": "47506fa4b8259fab1f0e4321176e253ea430f465",
    "fast_qi48_frame1": "8fe032cc92e5467683b8f9f1f6be344a399279f1",
    "fast_qi48_frame2": "b36bd48cdd28333f4bf1bc274b07689e1eaef0c7",
    "fast_qi48_frame3": "11c747beb1f11781437ab807eb521f11ea3e42af",
    "fast_qi48_frame4": "f0737ede6a6c6456d4dc0c08509c7cdcb87dca23",
    "fast_qi48_frame5": "0dfbce2cec92e349eef6a4e1987cc23c8d2eb8a4",
    "fast_qi48_frame6": "9c45c8872989f4d93f7b8b9526f294f4e9dbe267",
    "fast_qi48_frame7": "642e29dc41f09a70dceb9f543bed2c565e112fe4",
    "fast_pair_key_qi56_frame0": "3dbd2666bb6b529b7d0c1674375f01c3e9db35c3",
    "fast_pair_qi40_frame1": "d84d9f4c689902f9ed5d540dee9f1710dc9e6d19",
    "fast_pair_qi72_frame1": "8fb30d7df9d571125c9ed35e959cfa1a0e8f180e",
    "fast_pair_qi40_frame2": "c9627974fe2183a1f857d603519ed33e003e77cc",
    "fast_pair_qi72_frame2": "2e8c3e36d74f265af4e0633d1ed0ef18f7a9a3b9",
    "fast_pair_qi40_frame3": "c9fcc2b80892a1e79ce0856d9a6691771fd8b3a6",
    "fast_pair_qi72_frame3": "51edd9b519174c3e8143cc1f2dc0a76944200545",
    "fast_pair_qi40_frame4": "27820c05c9978663ffa801d66848d24a00454e57",
    "fast_pair_qi72_frame4": "4074ea661ebc13bfc37630ccad0d80811f2e0f63",
    "patch_bpred_qi48_frame0": "47506fa4b8259fab1f0e4321176e253ea430f465",
    "patch_bpred_qi48_frame1": "1134b497a9e57ab2cd90eb9c74824d7d12b3fd44",
    "patch_bpred_qi48_frame2": "aa25d2d22139c0695c2f26732f8e28d39884baba",
    "patch_bpred_qi48_frame3": "e0334a4420e0ec93438d2417827bd7ab41f9734f",
    "patch_bpred_qi48_frame4": "4f6844bb7ae642580e89995becd958e9bc3e69a1",
    "patch_bpred_qi48_frame5": "5376863914580eccbfd7de0e585e4d67635e1a8c",
    "patch_bpred_qi48_frame6": "5318e314d5b40eab83299b7bb43e782382f23486",
    "patch_bpred_qi48_frame7": "066fd685b8ca2c7abf5d5f8cc44b51485aea304e",
    "patch_bpred_pair_key_qi56_frame0": "3dbd2666bb6b529b7d0c1674375f01c3e9db35c3",
    "patch_bpred_pair_qi40_frame1": "c7a6119893686092b9977ca0b4c4b85fcb3423c4",
    "patch_bpred_pair_qi72_frame1": "4c4e029024d261f6b72d14c5a8fcd527bb978e81",
    "patch_bpred_pair_qi40_frame2": "e506be99947272f6c9d52d03623a3ee2348140bc",
    "patch_bpred_pair_qi72_frame2": "02492b2ae6648c9bd7da9b3d6c025aad941a0e5d",
    "patch_bpred_pair_qi40_frame3": "7b00a3f1827fa3aa47e424123435128cd8e6c3d9",
    "patch_bpred_pair_qi72_frame3": "4a6d372255535a190d3c57fc33a691a018b7253a",
    "patch_bpred_pair_qi40_frame4": "21a86e76d0c66d3d28c5972d6d4132563bf51c68",
    "patch_bpred_pair_qi72_frame4": "a862ba23e040c195cecdbe7db9d3aec74842550a",
    "rebase_chunk0_frame0": "47506fa4b8259fab1f0e4321176e253ea430f465",
    "rebase_chunk0_frame1": "5a43f1834ae393854f1604eea366983c83f24aad",
    "rebase_chunk0_frame2": "7cb1fe690e3d384bf7238171762ecd75d7d6861b",
    "rebase_chunk0_frame3": "fefdc1f46300c2f640bd6b9bf00f2a850c9d52f1",
    "rebase_pred_frame4": "7367f428e8d42abb900979ea3aa0a5ad5a67d2e3",
    "rebase_pred_frame5": "b697067216c9f438c9491f77b99b946ebb27526b",
    "rebase_pred_frame6": "67cbcb8f8673f1629ee50f2a11c57cc140680f3b",
    "rebase_pred_frame7": "b783e22e0db6bed4932d87b9f3c3026cdd6bc243",
    "rebase_frame4": "a6d0f7e2b6a1409b834fad32db07e95eac44b15f",
    "rebase_frame5": "e8c24c5a1b2626654e7c6dfa07489ffd1606ae2d",
    "rebase_frame6": "c265cd01690f377d693d580109d5b0358203a38a",
    "rebase_frame7": "1667cdf4fa860c97f853fbc16e66352911f7bee0",
}


def offgrid_labels(name):
    """The OFFGRID_ENCODE_SHA1 keys of a run of OFFGRID_RUNS (or
    "rebase"), in payload order."""
    if name == "rebase":
        return (["rebase_chunk0_frame%d" % k for k in range(OFFGRID_CHUNK)]
                + ["rebase_pred_frame%d" % k
                   for k in range(OFFGRID_CHUNK, OFFGRID_FRAMES)]
                + ["rebase_frame%d" % k
                   for k in range(OFFGRID_CHUNK, OFFGRID_FRAMES)])
    if name == "kf_min_ssim":
        return ["kf_min_ssim_%.2f_frame0" % KF_MIN_SSIM]
    if name.startswith("kf_"):
        return ["%s_frame%d" % (name, k) for k in OFFGRID_KF_FRAMES]
    if name == "inter_pair":
        return ["inter_pair_key_qi%d_frame0" % INTER_PAIR_KEY_QI] + [
            "inter_pair_qi%d_frame1" % q for q in INTER_PAIR_QIS]
    if name == "inter_min_ssim":
        return ["inter_min_ssim_%.2f_frame%d" % (INTER_MIN_SSIM, k)
                for k in range(OFFGRID_INTER_FRAMES)]
    if name.startswith("inter_"):
        return ["%s_frame%d" % (name, k) for k in range(OFFGRID_INTER_FRAMES)]
    if FAST_RUNS[name][1]:
        return ["%s_key_qi%d_frame0" % (name, FAST_PAIR_KEY_QI)] + [
            "%s_qi%d_frame%d" % (name, q, k)
            for k in range(1, OFFGRID_PAIR_FRAMES + 1) for q in FAST_PAIR_QIS]
    return ["%s_qi%d_frame%d" % (name, FAST_QI, k)
            for k in range(OFFGRID_FRAMES)]


def offgrid_step(name):
    """Payloads a step after a run's first frame: a pair's quantizers."""
    if name == "inter_pair":
        return len(INTER_PAIR_QIS)
    return len(FAST_PAIR_QIS) if FAST_RUNS.get(name, (0, 0))[1] else 1


def offgrid_encode_run(name, frames, width, height):
    """One run of OFFGRID_RUNS on the card over ``frames`` (display
    (y, u, v) planes), as OFFGRID_ENCODE_SHA1 describes: (payloads, the
    encoder's minihash after each, the luma SSIM of LAST against the
    source after each (the fast runs'), the host-patched macroblocks of
    each)."""
    pls, mhs, quals, patched = [], [], [], []

    def kept(payload, enc, k=None):
        pls.append(payload)
        mhs.append(enc.minihash())
        patched.append(getattr(enc, "patched_mbs", 0) if pls[1:] else 0)
        if k is not None:
            src = torch.from_numpy(np.ascontiguousarray(frames[k][0]))
            quals.append(float(ssim(enc.references.last.y[:height, :width],
                                    src.to(DEV))))

    kf = {"kf_" + n: (qi, tp) for n, qi, tp in KF_ENCODE_MODES}
    inter = {"inter_" + n: (qi, q, tp) for n, qi, q, tp in INTER_ENCODE_MODES}
    if name in kf:
        qi, two_pass = kf[name]
        e = Encoder(width, height, two_pass=two_pass, device=DEV)
        for k in OFFGRID_KF_FRAMES:
            kept(e.encode_with_quantizer(frames[k], qi, key_frame=True), e)
    elif name == "kf_min_ssim":
        e = Encoder(width, height, device=DEV)
        kept(e.encode_with_minimum_ssim(frames[0], KF_MIN_SSIM,
                                        key_frame=True), e)
    elif name in inter:
        qi, quality, two_pass = inter[name]
        e = Encoder(width, height, quality=quality, two_pass=two_pass,
                    device=DEV)
        for k in range(OFFGRID_INTER_FRAMES):
            kept(e.encode_with_quantizer(frames[k], qi, key_frame=k == 0), e)
    elif name == "inter_min_ssim":
        e = Encoder(width, height, device=DEV)
        for k in range(OFFGRID_INTER_FRAMES):
            kept(e.encode_with_minimum_ssim(frames[k], INTER_MIN_SSIM,
                                            key_frame=k == 0), e)
    elif name == "inter_pair":
        e = Encoder(width, height, quality="rt", device=DEV)
        kept(e.encode_with_quantizer(frames[0], INTER_PAIR_KEY_QI,
                                     key_frame=True), e)
        forks = [e.fork() for _ in INTER_PAIR_QIS]
        for (payload, _), f in zip(encode_inter.encode_interframe_multiqp(
                forks, frames[1],
                [QuantIndices(y_ac_qi=q) for q in INTER_PAIR_QIS]), forks):
            kept(payload, f)
    else:
        bpred, pair = FAST_RUNS[name]
        e = Encoder(width, height, quality="rt", fast=True, fast_bpred=bpred,
                    device=DEV)
        kept(e.encode_with_quantizer(frames[0], FAST_PAIR_KEY_QI if pair
                                     else FAST_QI, key_frame=True), e, 0)
        if pair:
            for k in range(1, OFFGRID_PAIR_FRAMES + 1):
                forks = [e.fork() for _ in FAST_PAIR_QIS]
                for (payload, _), f in zip(
                        encode_inter_fast.encode_interframe_fast_multiqp(
                            forks, frames[k], [QuantIndices(y_ac_qi=q)
                                               for q in FAST_PAIR_QIS]),
                        forks):
                    kept(payload, f, k)
                e = forks[0]        # on with the first quantizer's stream
        else:
            for k in range(1, OFFGRID_FRAMES):
                kept(e.encode_with_quantizer(frames[k], FAST_QI), e, k)
    return pls, mhs, quals, patched


def offgrid_rebase(frames, width, height, work):
    """xc enc -O of chunk 0 (frames 0-3) and xc enc of the prediction
    chunk (frames 4-7) at REBASE_QI, then xc enc -r of the prediction onto
    chunk 0's state at REBASE_KF_WEIGHT, through the port's CLI on the
    card; the same rebase through the API for the encoder's minihash
    after each frame.  Returns (chunk 0's, the prediction's and the
    rebased payloads, {check: ok})."""
    f = lambda name: os.path.join(work, name)
    write_y4m(f("og_chunk0.y4m"), frames[:OFFGRID_CHUNK], width, height)
    write_y4m(f("og_chunk1.y4m"), frames[OFFGRID_CHUNK:OFFGRID_FRAMES],
              width, height)
    qi, dev = str(REBASE_QI), ["--device", str(DEV)]
    rcs = [xc.main(["enc", f("og_chunk0.y4m"), "-y", qi, "-o",
                    f("og_chunk0.ivf"), "-O", f("og_chunk0.state")] + dev),
           xc.main(["enc", f("og_chunk1.y4m"), "-y", qi, "-o",
                    f("og_pred.ivf")] + dev),
           xc.main(["enc", f("og_chunk1.y4m"), "-r", "-I",
                    f("og_chunk0.state"), "-p", f("og_pred.ivf"), "-w",
                    str(REBASE_KF_WEIGHT), "-o", f("og_rebased.ivf")] + dev)]
    chunk0, pred_pls, rebased = (list(IVFReader(f(n))) for n in (
        "og_chunk0.ivf", "og_pred.ivf", "og_rebased.ivf"))
    with open(f("og_chunk0.state"), "rb") as fh:
        state = fh.read()
    pred = RB.parse_prediction(pred_pls, Decoder(width, height, device=DEV))
    enc = Encoder(width, height, device=DEV)
    enc.state, enc.references = serdes.load_decoder(state, device=DEV)
    sink = FrameSink(enc)
    RB.reencode(enc, frames[OFFGRID_CHUNK:OFFGRID_FRAMES], pred,
                REBASE_KF_WEIGHT, False, sink)
    # chunk 0 decoded from scratch writes the bytes of its state file; the
    # rebased frames, decoded from that state, reach the encoder's minihash
    # after each
    dec = Decoder(width, height, device=DEV)
    for p in chunk0:
        dec.decode_frame(p)
    s0, r0 = serdes.load_decoder(state, device=DEV)
    ok = {"cli_exit_codes": all(rc in (0, None) for rc in rcs),
          "chunk0_decoded_state_file": serdes.save_decoder(
              dec.state, dec.references) == state,
          "api_payloads_equal_cli": sink.payloads == rebased}
    dec = Decoder(width, height, state=s0, references=r0, device=DEV)
    decoded = []
    for p, mh in zip(rebased, sink.minihashes):
        dec.decode_frame(p)
        decoded.append(dec.minihash() == mh)
    ok["rebased_decode_minihash"] = bool(decoded) and all(decoded)
    return chunk0 + pred_pls + rebased, ok


def offgrid_encode_phase(card):
    """The offgrid_encode phase (see the module docstring); returns its
    result line."""
    t0 = time.perf_counter()
    frames = [r.display() for r in FilePlayer(OFFGRID_CLIP, device=DEV)]
    ivf = IVFReader(OFFGRID_CLIP)
    width, height = ivf.width, ivf.height
    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    serial = serial_rt_reference(frames, width, height,
                                 range(1, OFFGRID_FRAMES))

    # the off-grid encode path: counters to 0 just before, read just after
    zero_counts()
    got, decode_ok, per_run, runs = {}, {}, {}, {}
    for name in OFFGRID_RUNS:
        before = read_counts()[0]
        pls, mhs, quals, patched = runs[name] = offgrid_encode_run(
            name, frames, width, height)
        per_run[name] = {k: v - before[k] for k, v in read_counts()[0].items()
                         if v - before[k]}
        got.update(zip(offgrid_labels(name), pls))
        decode_ok[name] = redecode_ok(pls, mhs, offgrid_step(name), width,
                                      height)
    before = read_counts()[0]
    pls, rebase_ok = offgrid_rebase(frames, width, height, work)
    per_run["rebase"] = {k: v - before[k] for k, v in read_counts()[0].items()
                         if v - before[k]}
    got.update(zip(offgrid_labels("rebase"), pls))
    calls, kernels = read_counts()
    sha_ok = {k: hashlib.sha1(p).hexdigest() == OFFGRID_ENCODE_SHA1.get(k)
              for k, p in got.items()}
    parity = {name: rd_parity((name, runs[name][0], None, None,
                               runs[name][2]), *serial)
              for name in ("fast", "patch_bpred")}
    line = dict(
        card=card, width=width, height=height, frames=len(frames),
        payloads=len(got), seconds=time.perf_counter() - t0,
        sha1_ok=all(sha_ok.values()) and set(got) == set(OFFGRID_ENCODE_SHA1),
        sha1_differing=sorted(k for k, ok in sha_ok.items() if not ok),
        decode_minihash_ok={k: all(v) for k, v in decode_ok.items()},
        rebase=rebase_ok,
        rd_parity={k: v[0] for k, v in parity.items()},
        rd_parity_ok={k: v[1] for k, v in parity.items()},
        patched_mbs_per_frame={k: runs[k][3] for k in FAST_RUNS
                               if FAST_RUNS[k][0]},
        sizes={k: [len(p) for p in v[0]] for k, v in runs.items()},
        launches=calls, kernel_launches=kernels, launches_by_run=per_run)
    say("offgrid_encode", **line)
    if not line["sha1_ok"]:
        raise SystemExit("off-grid encodes differ from OFFGRID_ENCODE_SHA1: "
                         "%s" % (line["sha1_differing"]
                                 or sorted(set(OFFGRID_ENCODE_SHA1)
                                           ^ set(got))))
    if not all(line["decode_minihash_ok"].values()) \
            or not all(rebase_ok.values()):
        raise SystemExit("an off-grid frame does not re-decode to its "
                         "encoder's minihash: %s %s"
                         % (line["decode_minihash_ok"], rebase_ok))
    if not all(v[1] for v in parity.values()):
        raise SystemExit("the off-grid fast stream left the serial rt "
                         "encoder's RD band")
    encode_kernels = ("predict_mb_tiles", "loop_filter", "encode_kf_frame",
                      "encode_inter_frame", "decide_inter_frame",
                      "intra_fixup_frame", "rebase_frame")
    if any(calls[k] <= 0 or kernels[k] != calls[k] for k in encode_kernels):
        raise SystemExit("the off-grid encodes did not launch K3, K5, K7, "
                         "K8, K9, K10 and the residue kernel, each one "
                         "launch a call")
    if per_run["patch_bpred"].get("intra_fixup_frame") \
            or not per_run["fast"].get("intra_fixup_frame"):
        raise SystemExit("K10 ran in the off-grid host-patch stream, or not "
                         "in the fast stream")
    return line


# target_size_encode: xc enc -F (Encoder.encode_with_target_size: a binary
# search on the quantizer whose size estimator encodes a mosaic of every
# 4th macroblock through a trial encoder) over decoded frames 0-5 of the
# 720p fixture (an 11 x 20 macroblock mosaic, 320x176) and of
# natural/cut_360x242_q56.ivf (off the grid, a 4 x 5 mosaic, a scene cut
# at frame 4), in best, rt and rt --fast.  TARGET_SIZES gives each frame
# its target in bytes; frame 3's is below what even the search window's
# largest quantizer makes of it, so the search takes its floor branch
# there.  TARGET_SIZE_SHA1: SHA-1 of each frame the JAX package's xc enc
# -F makes of the same y4m input (best and rt: its CLI, the host encoder;
# --fast: its encoder as its CLI's --fast sets it up, the key frame on the
# host, whose frames equal its key-frame kernel's, the interframes and
# their trial encodes on its fast path).  Computed once on a CPU host;
# tests/test_torch_inter_encoder.py recomputes them (-m slow).
TARGET_SIZE_FRAMES = 6
TARGET_SIZE_CLIPS = (("720p", CLIP), ("360x242", OFFGRID_CLIP))
TARGET_SIZES = {"720p": (60000, 55000, 50000, 500, 34000, 40000),
                "360x242": (2400, 1200, 1000, 40, 2000, 1200)}
TARGET_SIZE_MODES = (("best", ("-q", "best")), ("rt", ("-q", "rt")),
                     ("rt_fast", ("-q", "rt", "--fast")))
TARGET_SIZE_SHA1 = {
    "720p_best_frame0": "9d5e798d0632ee753d11ea60c1974a916a9b3b0c",
    "720p_best_frame1": "353e591533c72ef929db605da32de67a24db107e",
    "720p_best_frame2": "7ad05e038da7debc5900881e665b836afbc89e5b",
    "720p_best_frame3": "a795c9ecf98802f0520ca5fc696ad2c2553966be",
    "720p_best_frame4": "bbd708089de9d37635965b36c48446e7e6719eae",
    "720p_best_frame5": "0be5443476625bdbb45b85aeea671edc1142f013",
    "720p_rt_fast_frame0": "9d5e798d0632ee753d11ea60c1974a916a9b3b0c",
    "720p_rt_fast_frame1": "387c09fe0ce06f5e1d05835cf0dedceae8847a3a",
    "720p_rt_fast_frame2": "cc467235aee949dd7b27f2d403d2548932df7bb0",
    "720p_rt_fast_frame3": "58c094a30882363334902c45360844f5600a0043",
    "720p_rt_fast_frame4": "4da9da4ba0c218af25030aca40c4490c92f1a14b",
    "720p_rt_fast_frame5": "9d97f338ba1416578918dd8c171fcd6fe8ccd50b",
    "720p_rt_frame0": "9d5e798d0632ee753d11ea60c1974a916a9b3b0c",
    "720p_rt_frame1": "dd8fa67c668904c3f69198eac5098ad5f4d46055",
    "720p_rt_frame2": "34c8459bf8bf2dcd05e533826acb64dd9648bfc5",
    "720p_rt_frame3": "8272460208beb2d2022189379c857e7f6f87411e",
    "720p_rt_frame4": "7bdeae3a588973f5ba454b929e2d49861f68d49a",
    "720p_rt_frame5": "23e74fa15acd5536e94d3d20a261d62f4b307972",
    "360x242_best_frame0": "28cc8e0727559b619c500ed0a3c0a1110e647224",
    "360x242_best_frame1": "4252f16cfe8da359b404f90d129456f8cdc50262",
    "360x242_best_frame2": "cf56cfcdce4c80e02b24825286e9977652dbfaae",
    "360x242_best_frame3": "bb95a7d6fb3ad58d90c6538ae2dda49e23094286",
    "360x242_best_frame4": "559933a6ab6608a991028b2715cca8909341c069",
    "360x242_best_frame5": "c5be4a23164cac58349c1435730e5b4a82216266",
    "360x242_rt_fast_frame0": "28cc8e0727559b619c500ed0a3c0a1110e647224",
    "360x242_rt_fast_frame1": "dfc3b300159da063d23217758781be77aa9116a9",
    "360x242_rt_fast_frame2": "865377cda1e31285d9f3c4e995e746509c05755f",
    "360x242_rt_fast_frame3": "132d721b22f53f5d09307011ac3851cf95e3ba67",
    "360x242_rt_fast_frame4": "588e360121532b99a9c2bb892d58c2ee863b19c2",
    "360x242_rt_fast_frame5": "e299f93e5570709c2bfa6f5a334e8e060412f975",
    "360x242_rt_frame0": "28cc8e0727559b619c500ed0a3c0a1110e647224",
    "360x242_rt_frame1": "d44936d08ef7f3955cdff91997b3a675b8402aa4",
    "360x242_rt_frame2": "bba7e6c7db1267dcbf7773a89f09eb3b10e734ff",
    "360x242_rt_frame3": "785d19ea04392f041d9598fa533e5963da467e4a",
    "360x242_rt_frame4": "96f710f74ba6147c3a978c31d3b68d38eba40fe7",
    "360x242_rt_frame5": "193ff03c3be5f8bcc1a4ce88376eb0a1143d3490",
}


def target_size_labels(clip, mode):
    """The TARGET_SIZE_SHA1 keys of one clip and mode, in frame order."""
    return ["%s_%s_frame%d" % (clip, mode, k)
            for k in range(TARGET_SIZE_FRAMES)]


def target_size_inputs(work, name, path):
    """Decoded frames 0-5 of ``path`` on the card written as a y4m file,
    and the targets as xc enc -F's file: (y4m path, sizes path, frames,
    width, height)."""
    frames = decoded_frames(path, tuple(range(TARGET_SIZE_FRAMES)))
    frames = [frames[k].display() for k in range(TARGET_SIZE_FRAMES)]
    width, height = IVFReader(path).width, IVFReader(path).height
    y4m = os.path.join(work, "ts_%s.y4m" % name)
    sizes = os.path.join(work, "ts_%s.sizes" % name)
    write_y4m(y4m, frames, width, height)
    with open(sizes, "w") as fh:
        fh.write("".join("%d\n" % n for n in TARGET_SIZES[name]))
    return y4m, sizes, frames, width, height


def recorded_searches(run):
    """Run ``run()`` with the port's Encoder's size search recorded: per
    encode_with_target_size call its target, each trial encode's (quantizer,
    estimate), the chosen quantizer, the payload's size and the encoder's
    minihash after it, and the mosaic's size as the trial encoder has it;
    and the wrapper calls made inside trial encodes (at the mosaic's
    shape).  Returns (run's result, searches, calls)."""
    searches, trial_calls = [], dict.fromkeys(COUNTS, 0)
    search, estimate, trial = Encoder.encode_with_target_size, \
        Encoder.estimate_frame_size, Encoder.trial_encoder

    def searched(self, yuv, target_size, key_frame=None):
        searches.append(dict(target=int(target_size), trials=[]))
        payload = search(self, yuv, target_size, key_frame)
        searches[-1].update(qi=self.last_y_ac_qi, bytes=len(payload),
                            minihash=self.minihash())
        return payload

    def estimated(self, yuv, y_ac_qi, key_frame=None):
        before = read_counts()[0]
        n = estimate(self, yuv, y_ac_qi, key_frame)
        for k, v in read_counts()[0].items():
            trial_calls[k] += v - before[k]
        searches[-1]["trials"].append((int(y_ac_qi), n))
        return n

    def trial_encoder(self, yuv, key_frame):
        sub, planes = trial(self, yuv, key_frame)
        searches[-1]["mosaic"] = "%dx%d" % (sub.width, sub.height)
        return sub, planes

    Encoder.encode_with_target_size = searched
    Encoder.estimate_frame_size = estimated
    Encoder.trial_encoder = trial_encoder
    try:
        out = run()
    finally:
        Encoder.encode_with_target_size = search
        Encoder.estimate_frame_size = estimate
        Encoder.trial_encoder = trial
    return out, searches, trial_calls


def target_size_encode_phase(card):
    """The target_size_encode phase (see the module docstring); returns its
    result line."""
    t0 = time.perf_counter()
    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    inputs = {name: target_size_inputs(work, name, path)
              for name, path in TARGET_SIZE_CLIPS}
    # the size-search path: counters to 0 just before, read just after
    zero_counts()
    got, runs, mosaic_calls = {}, {}, dict.fromkeys(COUNTS, 0)
    for name, _ in TARGET_SIZE_CLIPS:
        y4m, sizes, _, width, height = inputs[name]
        for mode, flags in TARGET_SIZE_MODES:
            out = os.path.join(work, "ts_%s_%s.ivf" % (name, mode))
            (rc, _, err, ms), searches, calls = recorded_searches(
                lambda: run_xc(["enc", y4m, "-o", out, "-F", sizes,
                                "--device", str(DEV)] + list(flags)))
            pls = list(IVFReader(out)) if rc == 0 else []
            got.update(zip(target_size_labels(name, mode), pls))
            for k, v in calls.items():
                mosaic_calls[k] += v
            runs[name, mode] = dict(rc=rc, wall_ms=ms, payloads=pls,
                                    searches=searches, width=width,
                                    height=height, stderr_tail=err[-300:])
    calls, kernels = read_counts()
    sha_ok = {k: hashlib.sha1(p).hexdigest() == TARGET_SIZE_SHA1.get(k)
              for k, p in got.items()}
    detail, decode_ok, fits = {}, {}, {}
    floor_taken = []
    for (name, mode), r in runs.items():
        key = "%s_%s" % (name, mode)
        pls, searches = r["payloads"], r["searches"]
        # every payload re-decodes from scratch to the encoder's minihash
        dec = Decoder(r["width"], r["height"], device=DEV)
        decode_ok[key] = len(pls) == len(searches) == TARGET_SIZE_FRAMES
        fits[key] = []
        for p, s in zip(pls, searches):
            dec.decode_frame(p)
            decode_ok[key] &= dec.minihash() == s["minihash"]
            floor = all(est > s["target"] for _, est in s["trials"])
            floor_taken += [floor]
            s.update(floor=floor, estimate=dict(s["trials"]).get(s["qi"]))
            fits[key].append(floor or len(p) <= s["target"])
        detail[key] = dict(
            rc=r["rc"], wall_ms=r["wall_ms"],
            trials_per_frame=[len(s["trials"]) for s in searches],
            qi=[s["qi"] for s in searches],
            bytes=[s["bytes"] for s in searches],
            targets=[s["target"] for s in searches],
            estimates=[s["estimate"] for s in searches],
            floor=[s["floor"] for s in searches],
            trials=[s["trials"] for s in searches])
    mosaic = {name: sorted({s["mosaic"] for (n, _), r in runs.items()
                            if n == name for s in r["searches"]})
              for name in inputs}
    line = dict(
        card=card, frames=TARGET_SIZE_FRAMES, mosaic=mosaic,
        payloads=len(got), seconds=time.perf_counter() - t0,
        sha1_ok=all(sha_ok.values()) and set(got) == set(TARGET_SIZE_SHA1),
        sha1_differing=sorted(k for k, ok in sha_ok.items() if not ok),
        decode_minihash_ok=decode_ok, fits_target_or_floor=fits,
        floor_frames=sum(floor_taken), runs=detail,
        launches=calls, kernel_launches=kernels,
        launches_in_trial_encodes=mosaic_calls)
    say("target_size_encode", **line)
    if any(r["rc"] for r in runs.values()):
        raise SystemExit("xc enc -F failed: %s" % {
            k: (r["rc"], r["stderr_tail"]) for k, r in runs.items()
            if r["rc"]})
    if not line["sha1_ok"]:
        raise SystemExit("target-size encodes differ from TARGET_SIZE_SHA1: "
                         "%s" % (line["sha1_differing"]
                                 or sorted(set(TARGET_SIZE_SHA1)
                                           ^ set(got))))
    if not all(decode_ok.values()):
        raise SystemExit("a target-size frame does not re-decode to its "
                         "encoder's minihash: %s" % decode_ok)
    if not all(all(v) for v in fits.values()) or not any(floor_taken):
        raise SystemExit("a target-size frame exceeds its target without "
                         "the floor branch, or no search took the floor "
                         "branch: %s" % fits)
    if min(len(s["trials"]) for r in runs.values()
           for s in r["searches"]) < 3:
        raise SystemExit("a frame's size search took fewer than three "
                         "trial encodes")
    trial_kernels = ("encode_kf_frame", "encode_inter_frame",
                     "decide_inter_frame", "intra_fixup_frame")
    if any(mosaic_calls[k] <= 0 for k in trial_kernels) \
            or any(kernels[k] != calls[k] for k in trial_kernels):
        raise SystemExit("the trial encodes did not launch K7, K8, K9 and "
                         "K10 at the mosaic's shape, each one launch a call")
    return line


def padded_raster(raster):
    """A decoded raster's display planes padded with zeros to whole
    macroblocks on the card, as the encoder uploads them (kf_args takes
    its y, u, v)."""
    r = _pad_raster(*raster.display(), raster.display_width,
                    raster.display_height)
    return SimpleNamespace(**{p: torch.from_numpy(getattr(r, p)).to(DEV)
                              for p in "yuv"})


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
    then the corpus_decode, keyframe_encode, inter_encode, fast_encode and
    offgrid_encode phases; returns their six result lines."""
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

    cd = corpus_decode_phase(card)
    kf = keyframe_encode_phase(card, width, height)
    inter = inter_encode_phase(card, width, height)
    fast = fast_encode_phase(card, width, height,
                             inter["speed"]["rt_qi48"]["ms_per_interframe"])
    og = offgrid_encode_phase(card)
    return single, cd, kf, inter, fast, og


# the memory_checks phase's time limit on the card
MEMORY_CHECK_S = 150.0


def corrupted_stream_checks():
    """sanitize_fuzz's corrupted streams (truncations and byte flips of
    inter_176x144_q32.ivf) through a concealing Decoder on the card, once
    under each fill of poison_check.PATTERNS (the allocator's free blocks
    and every SM's shared memory filled before each frame): each frame's
    raster SHA-1, or exception class, against sanitize_fuzz.CORRUPT_TABLE,
    the port's CPU decode of the same bytes.  Returns the summary line's
    fields."""
    table = sanitize_fuzz.load_table()
    path = os.path.join(REPO, "tests", "fixtures", sanitize_fuzz.CORRUPT_CLIP)
    ivf = IVFReader(path)
    streams = sanitize_fuzz.corrupted_streams(path)
    # the cache shrunk to the decoder's own blocks (one clean decode), so
    # that each frame's fill is small
    torch.cuda.empty_cache()
    sanitize_fuzz.decode_outcomes([ivf.frame(i) for i in range(len(ivf))],
                                  ivf.width, ivf.height, DEV)
    bad, frames, raised = [], 0, 0
    for name, payloads in streams:
        want = table.get(name)
        if want is None or want["stream_sha1"] != \
                sanitize_fuzz.stream_sha1(payloads):
            bad.append({"stream": name, "why": "not the recorded bytes"})
            continue
        for byte in poison_check.PATTERNS:
            def fill(byte=byte):
                poison_check.fill_cached(byte, DEV)
                poison_check.poison_shared(byte, DEV)
            got = sanitize_fuzz.decode_outcomes(payloads, ivf.width,
                                                ivf.height, DEV, fill)
            frames += len(got)
            raised += sum(o.startswith("raise:") for o in got)
            diff = [(i, g, w) for i, (g, w) in enumerate(zip(got,
                                                             want["frames"]))
                    if g != w]
            if diff or len(got) != len(want["frames"]):
                bad.append({"stream": name, "pattern": byte,
                            "frames_differing": diff[:4]})
    return dict(streams=len(streams), fills=len(poison_check.PATTERNS),
                frames_decoded=frames, frames_raised=raised,
                streams_matching=len(streams) - len({b["stream"] for b in bad}),
                mismatches=bad[:8])


def memory_checks_phase(card):
    """The memory-safety check of every hand-written kernel on the card
    (tools/poison_check.py; compute-sanitizer does not run here): its three
    positive controls, which it must catch; every case of the kernels phase
    once under each fill, each run torch.equal to the plain version's
    output with every guard intact; the corrupted streams through the
    single-frame decoder (K3, K4, K5).  One line a kernel, one for the
    controls, one for the streams and a summary; fails on a missed
    control, a difference, a broken guard, a stream unlike the CPU's or
    more than MEMORY_CHECK_S seconds."""
    t0 = time.perf_counter()
    sms, smem = poison_check.shared_geometry()
    ctl = poison_check.controls(DEV)
    say("memory_checks", card=card, controls=ctl, sms=sms,
        shared_bytes_filled_per_sm=smem, patterns=poison_check.PATTERNS)
    kernels = {}
    for kernel, label, call, args, want in MEMORY_CASES:
        runs = poison_check.check_case(call, args, want)
        k = kernels.setdefault(kernel, dict(
            cases=0, runs=0, differences=0, broken_guards=0, guards=0,
            allocated_guards=0, broken_allocated_guards=0,
            cache_filled_min=None, cache_left_max=0, failing=[]))
        k["cases"] += 1
        k["runs"] += len(runs)
        k["differences"] += sum(not r["equal"] for r in runs)
        k["broken_guards"] += sum(r["broken_guards"] for r in runs)
        k["guards"] += sum(r["guards"] for r in runs)
        k["allocated_guards"] += sum(r["allocated_guards"] for r in runs)
        k["broken_allocated_guards"] += sum(r["broken_allocated_guards"]
                                            for r in runs)
        filled = min(r["cache_filled"] for r in runs)
        k["cache_filled_min"] = filled if k["cache_filled_min"] is None \
            else min(k["cache_filled_min"], filled)
        k["cache_left_max"] = max([k["cache_left_max"]]
                                  + [r["cache_left"] for r in runs])
        if poison_check.caught(runs):
            k["failing"].append({"case": label, "runs": runs})
    MEMORY_CASES.clear()
    for kernel, k in kernels.items():
        say("memory_checks", kernel=kernel, **k)
    streams = corrupted_stream_checks()
    say("memory_checks", corrupted_streams=streams)
    seconds = time.perf_counter() - t0
    summary = dict(
        card=card, seconds=seconds,
        controls_caught={k: v["caught"] for k, v in ctl.items()},
        kernels={k: {f: v[f] for f in ("cases", "runs", "differences",
                                      "broken_guards", "allocated_guards",
                                      "broken_allocated_guards")}
                 for k, v in kernels.items()},
        streams_matching=streams["streams_matching"],
        streams=streams["streams"])
    say("memory_checks", **summary)
    if not all(v["caught"] for v in ctl.values()):
        raise SystemExit("the memory check missed a positive control: %s"
                         % summary["controls_caught"])
    if any(v["differences"] or v["broken_guards"]
           or v["broken_allocated_guards"] for v in kernels.values()):
        raise SystemExit("a kernel's output changed with the fill, or it "
                         "broke a guard (memory_checks lines above)")
    if any(not v["allocated_guards"] for v in kernels.values()):
        raise SystemExit("a kernel's wrapper allocated nothing through "
                         "ops/alloc.py under the check")
    if streams["mismatches"] or streams["streams_matching"] \
            != streams["streams"]:
        raise SystemExit("a corrupted stream decodes on the card unlike on "
                         "the CPU")
    if seconds > MEMORY_CHECK_S:
        raise SystemExit("memory_checks took %.1f s, over %.0f s"
                         % (seconds, MEMORY_CHECK_S))
    return summary


# the kernels whose every call on the paths is checked to be one launch
PER_CALL = {"predict_mb_tiles": sixtap_cuda, "intra_frame": intra_cuda,
            "loop_filter": lf_cuda, "encode_kf_frame": enc_intra_cuda,
            "encode_inter_frame": enc_inter_cuda,
            "decide_inter_frame": enc_decide_cuda,
            "intra_fixup_frame": enc_intra_fixup_cuda,
            "rebase_frame": rebase_cuda, "wavefront_decode": wavefront_cuda}

# the paths --only runs alone (each needs nothing of another)
ALONE = {"corpus_decode": lambda card, w, h: corpus_decode_phase(card),
         "offgrid_encode": lambda card, w, h: offgrid_encode_phase(card),
         "target_size_encode":
             lambda card, w, h: target_size_encode_phase(card),
         "salsify": salsify_phase, "salsify_link": salsify_link_phase}


def one_launch_a_call(per_call, required):
    """Print each kernel's calls and launches a call on the paths; fail if
    a call issued other than one launch, or a ``required`` kernel was never
    called."""
    persistent = {k: {"calls": len(v), "launches_per_call": sorted(set(v))}
                  for k, v in per_call.items()}
    say("persistent_launches", **persistent)
    if any(set(v) - {1} or (k in required and not v)
           for k, v in per_call.items()):
        raise SystemExit("a K1, K3, K4, K5, K7, K8, K9, K10, six-tap or "
                         "residue-kernel call of its paths issued other than "
                         "one kernel launch")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device")
    quick = "--quick" in sys.argv[1:]
    only = []
    if "--only" in sys.argv[1:]:
        only = sys.argv[sys.argv.index("--only") + 1].split(",")
        unknown = sorted(set(only) - set(ALONE))
        if unknown:
            raise SystemExit("--only takes %s, not %s"
                             % (",".join(ALONE), ",".join(unknown)))
    t_start = time.perf_counter()
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
    if only:
        # the named paths alone: no kernel phase, no memory checks
        per_call, undo = record_launches(PER_CALL)
        try:
            for name in only:
                ALONE[name](card, ivf.width, ivf.height)
        finally:
            undo()
        one_launch_a_call(per_call, ())
        say("total", card=card, seconds=time.perf_counter() - t_start,
            only=only)
        print(card, flush=True)
        return

    # a small geometry with odd macroblock counts (9 x 11) and G=3 first
    small = IVFReader(SMALL_CLIP)
    kept = real_kernel_inputs([small.frame(0), small.frame(1)], small.width,
                              small.height, 3)
    small_cases = [
        k2_case("176x144 G=3 frame1", kept["mc"]),
        k1_case("176x144 frame1 interframe", kept["wave_inter"]),
        k1_case("176x144 frame0 key frame", kept["wave_key"]),
    ]
    # the G=14 batch of distinct QCIF clips: each GOP a different stream
    qcif = corpus.groups()[0]
    kept = real_kernel_inputs(
        [[c.payloads[f] for c in qcif.clips] for f in (0, 1)], qcif.width,
        qcif.height, len(qcif.clips))
    distinct = [
        k2_case("176x144 G=14 distinct clips frame1", kept["mc"]),
        k1_case("176x144 G=14 distinct clips frame1 interframe",
                kept["wave_inter"]),
        k1_case("176x144 G=14 distinct clips frame0 key frame",
                kept["wave_key"]),
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
    # off the grid: 90x48, 3 x 6 macroblocks with partial ones at the right
    tiny = IVFReader(TINY_CLIP)
    sf_tiny = single_frame_kernel_inputs([tiny.frame(0), tiny.frame(1)],
                                         tiny.width, tiny.height)
    k3.append(k3_case("90x48 frame1", sf_tiny[("predict_mb_tiles", 1)][0]))
    k4 += [k4_case("90x48 frame1 interframe", sf_tiny[("intra_frame", 1)][0]),
           k4_case("90x48 frame0 key frame", sf_tiny[("intra_frame", 0)][0])]
    k5 += [k5_case("90x48 frame1 interframe", sf_tiny[("loop_filter", 1)][0]),
           k5_case("90x48 frame0 key frame", sf_tiny[("loop_filter", 0)][0])]
    del sf, sf_small, synthetic, sf_tiny

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
    # off the grid: 360x242 (23 x 16 macroblocks, partial ones at the right
    # and the bottom), the arguments the encoders hand over for
    # OFFGRID_CLIP's frames (a scene cut before frame 4)
    og = decoded_frames(OFFGRID_CLIP, tuple(range(OFFGRID_FRAMES)))
    k7 += [k7_case("360x242 frame0 qi24", kf_args(padded_raster(og[0]), 24)),
           k7_case("360x242 frame4 two-pass qi32 default tables",
                   kf_args(padded_raster(og[4]), 32, tc_default))]
    k8 += [k8_case("360x242 frame1 best qi48",
                   k8_args(og[0], og[1], 48, [48])),
           k8_case("360x242 frame1 rt pair qi56 -> (40, 72)",
                   k8_args(og[0], og[1], INTER_PAIR_KEY_QI, INTER_PAIR_QIS,
                           "rt")),
           k8_case("360x242 scene cut: frame4 after frame0 two-pass qi32",
                   k8_args(og[0], og[4], 32, [32], two_pass=True))]
    og_fast = [("360x242 frame1 qi48",
                fast_kernel_inputs(og[0], og[1], 48, [FAST_QI])),
               ("360x242 frame1 pair qi56 -> (40, 72)", fast_kernel_inputs(
                   og[0], og[1], FAST_PAIR_KEY_QI, FAST_PAIR_QIS)),
               ("360x242 scene cut: frame4 after frame0 qi48",
                fast_kernel_inputs(og[0], og[4], 48, [FAST_QI]))]
    k9 += [k9_case(label, a9) for label, (a9, _, _) in og_fast]
    k10 += [k10_case(label, a10) for label, (_, a10, _) in og_fast]
    k3 += [k3_case("%s, LAST broadcast" % label, a3)
           for label, (_, _, a3) in og_fast]
    og_frames = [og[k].display() for k in range(OFFGRID_FRAMES)]
    k11 += [rebase_case("360x242 rebased frame %d qi%d"
                        % (OFFGRID_CHUNK + 1 + i, REBASE_QI), a)
            for i, a in enumerate(rebase_kernel_inputs(
                og_frames, og[0].display_width, og[0].display_height,
                OFFGRID_CHUNK, OFFGRID_FRAMES))]
    del og, og_fast, og_frames
    # the authored features off the grid: K1 and K2 on frames 0 and 1 of
    # the four streams at 170x138 as one G=4 batch, K3 on frame 1 of the
    # SPLITMV stream and of the golden/altref one (a Decoder each)
    work = os.path.join(REPO, "build", "chip_smoke", "kernel_features")
    os.makedirs(work, exist_ok=True)
    fw, fh = feature_streams.OFFGRID_SIZE
    feats = {name: list(IVFReader(path)) for name, path in
             feature_streams.write_all(work, device=DEV,
                                       size=(fw, fh)).items()}
    kept = real_kernel_inputs([[pl[f] for pl in feats.values()]
                               for f in (0, 1)], fw, fh, len(feats))
    feature_cases = [
        k2_case("170x138 G=4 feature streams frame1", kept["mc"]),
        k1_case("170x138 G=4 feature streams frame1 interframe",
                kept["wave_inter"]),
        k1_case("170x138 G=4 feature streams frame0 key frame",
                kept["wave_key"])]
    for name in ("feat_splitmv.ivf", "feat_goldalt.ivf"):
        sf = single_frame_kernel_inputs(feats[name], fw, fh)
        k3.append(k3_case("170x138 %s frame1" % name[5:-4],
                          sf[("predict_mb_tiles", 1)][0]))
    del kept, feats, sf
    # the size search's trial encodes at the 720p mosaic (11 x 20
    # macroblocks, 320x176), on the arguments estimate_frame_size hands
    # over: K7 on frame 0's mosaic; K8 (best, rt) and K9, K10 and K3 (fast)
    # on frame 1's against the mosaic of the LAST of an encoder that has
    # encoded frame 0 (LAST, GOLDEN and ALTREF one tensor)
    ts = decoded_frames(CLIP, (0, 1))
    sub, planes = mosaic_trial(None, ts[0])     # padded host planes
    my, mu, mv = (torch.from_numpy(p).to(DEV) for p in planes)
    k7.append(k7_case("720p mosaic 320x176 frame0 qi64",
                      kf_args(SimpleNamespace(y=my, u=mu, v=mv), 64)))
    for quality in ("best", "rt"):
        sub, planes = mosaic_trial(ts[0], ts[1], quality=quality)
        k8.append(k8_case("720p mosaic 320x176 frame1 %s qi48" % quality,
                          encode_inter.kernel_inputs(
                              sub, planes, [QuantIndices(y_ac_qi=48)])))
    sub, planes = mosaic_trial(ts[0], ts[1], quality="rt", fast=True)
    a9, a10, a3 = recorded_fast_frame(sub, planes, [FAST_QI])
    k9.append(k9_case("720p mosaic 320x176 frame1 qi48", a9))
    k10.append(k10_case("720p mosaic 320x176 frame1 qi48", a10))
    k3.append(k3_case("720p mosaic 320x176 frame1 qi48, LAST broadcast",
                      a3))
    del ts, sub, planes, my, mu, mv, a9, a10, a3
    say("kernels", helpers=helper_plain_ms())
    t_kernels = time.perf_counter() - t_start
    memory = memory_checks_phase(card)
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
    per_call, undo = record_launches(PER_CALL)
    try:
        single, cd, kf, inter, fast, og = persistent_paths(
            card, payloads, want, ivf.width, ivf.height)
        ts = target_size_encode_phase(card)
        rb = rebase_phase(card, ivf.width, ivf.height, rframes,
                          k11[0]["fetch_ms"])
        xt = xc_tools_phase(card, ivf.width, ivf.height, rframes)
        cl = cluster_phase(card, ivf.width, ivf.height, rframes)
        sal = salsify_phase(card, ivf.width, ivf.height)
        link = salsify_link_phase(card, ivf.width, ivf.height)
        mesh = mesh_phase(card, ivf.width, ivf.height, payloads)
    finally:
        undo()
    for k, v in k1_calls.items():
        per_call[k] = v + per_call.get(k, [])
    one_launch_a_call(per_call, set(per_call))
    # each kernel's calls on every path it runs on (the cluster's: those
    # of its rebase, in this process)
    paths = (single["launches"], cd["launches"], kf["launches"],
             inter["launches"], fast["launches"],
             fast["host_patch"]["launches"], og["launches"], ts["launches"],
             rb["launches"], xt["launches"],
             cl["launches_in_this_process"], sal["launches"],
             link["launches"], mesh["launches"])
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
              gop_calls["sixtap_mc"], cases[0],
              cases[:2] + small_cases[:1] + distinct[:1]
              + feature_cases[:1]),
        entry("wavefront_decode", "alfalfa_tpu_torch/csrc/wavefront.cu",
              "alfalfa_tpu/ops/wavefront_pm.py:432",
              gop_calls["wavefront_decode"], cases[2],
              cases[2:] + small_cases[1:] + distinct[1:]
              + feature_cases[1:]),
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
    say("corpus_decode", **{k: v for k, v in cd.items()
                            if k != "batch_detail"})
    say("keyframe_encode", **{k: v for k, v in kf.items()
                              if k != "device_profile"})
    say("inter_encode", **{k: v for k, v in inter.items()
                           if k != "device_profile"})
    say("fast_encode", **{k: v for k, v in fast.items()
                          if k != "device_profile"})
    say("offgrid_encode", **{k: v for k, v in og.items()
                             if k not in ("sizes", "launches_by_run")})
    say("target_size_encode", **{k: v for k, v in ts.items()
                                 if k != "runs"})
    say("rebase", **{k: v for k, v in rb.items() if k != "device_profile"})
    say("xc_tools", **{k: v for k, v in xt.items() if k != "stage_report"})
    say("cluster", **cl)
    say("salsify", **sal)
    say("salsify_link", **{k: v for k, v in link.items() if k != "runs"})
    say("mesh", **mesh)
    say("memory_checks", **memory)
    if simd is not None:
        say("main_path_simd", **simd)
    say("total", card=card, seconds=time.perf_counter() - t_start,
        to_memory_checks_s=t_kernels)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
