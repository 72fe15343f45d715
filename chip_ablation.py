#!/usr/bin/env python3
"""Ablation of the hand-written kernels' design steps on one NVIDIA GPU.

    python3 chip_ablation.py --parent DIR     # K4's and the six-tap
                                              # kernel's steps undone, K4's
                                              # clocked phases, the machine
                                              # code of K1, K5, K7-K10
                                              # against DIR's, and K4, the
                                              # six-tap kernel and K1 timed
                                              # against DIR's in alternation
                                              # (--kernels k4,mc,sass,pairs)
    python3 chip_ablation.py --kernels k1,sass,pairs --parent DIR
                                              # K1's and K10's steps undone,
                                              # the machine code, the pairs
    python3 chip_ablation.py --kernels k7     # K7's clocked phases only
    python3 chip_ablation.py --kernels rebase --parent DIR
                                              # the residue kernel's steps
                                              # undone; the residue update
                                              # and rebased frames/s, DIR's
                                              # tree against this one's

Writes variants of alfalfa_tpu_torch/csrc/ into build/ablation/<variant>/,
each the sources with one step of a redesign undone (or, for "separable",
one tried step added), builds them all at once (one nvcc per source) and
times them on 720p inputs chip_smoke.py makes, every variant in one
process, "kept" first and last for the spread; each output is compared
with the kept form's.  K4 and the six-tap kernel (kernels k4, mc): K4
(intra_frame) on the single-frame decoder's 720p and 176x144 interframe
and key frame with one and two warps a block, publishing every
macroblock, and clocked (thread 0's clock64() per phase, cycles a
macroblock); the six-tap kernel on the GOP path's 720p G=16 call, the
single-frame path's (also with the references stacked first, the
parent's copy) and the fast path's pair, with one thread a byte and with
four threads a 4x4 block.  K5 and K7 (kernels k5, k7): K7
(encode_kf_frame) on frame 0 one-pass at qi 24 and two-pass at qi 32, K8
rt on frame 1 (its intra macroblocks run K7's B_PRED chain), K5
(loop_filter) on the single-frame decoder's frame 1 and on the encoders'
8-level search call; K7's "clocked" variant adds thread 0's clock64() per
phase and prints cycles a macroblock.  K8 and K9 (kernels k8): K8
(encode_inter_frame) best and rt at qi 48, the rt pair, seeded extreme
motion, K9 (decide_inter_frame) one quantizer and the pair; its "clocked"
variant prints K8's phases.  K1 and K10 (kernels k1): K1
(wavefront_decode) on the GOP decoder's 720p G=16 interframe and key
frame, K10 (intra_fixup_frame) on the fast path's 720p frame 1, pair and
scene cut and 176x144.  The pairs (kernels pairs, with --parent): each
case of K4, the six-tap kernel and K1 timed from DIR's library and from
this checkout's, alternating which goes first, 12 readings a side (DIR's
K4 and six-tap kernel through their parent's wrappers, copied here, whose
entries' arguments this checkout changed: the six-tap kernel as the
parent's three per-plane calls on stacked references, made outside the
timing; the parent's six-tap calls also timed one by one and summed).
The spans (kernels spans, with --parent): enc.fast_kernel a fast rt
interframe and decode.reconstruct a frame at 720p, traced, in DIR's tree
and this one's, a fresh process each, in the order DIR, this, this, DIR.
The rebase (kernels rebase): the residue kernel (rebase_frame) on 720p
rebased frames 4 and 5's arguments, a frame of inter macroblocks and one
of intra ones, kept, with the inter pairs on the R row walkers alone
(rows_only: a block a row, no other blocks), with two blocks an SM
(two_blocks: registers held to 128), and with every intra macroblock
waiting at lag 2 (lag_two: ROW_LAG_WHOLE = 2), kept first and last; with --parent, chip_smoke's 720p rebase of frames 3-5 onto chunk 0
in DIR's tree and this one's the same way, a fresh process each (DIR,
this, this, DIR): rebased frames/s over five passes, then three traced
passes with each update_residues call timed (the device drained at both
ends) and the residue update's own spans summed.
Prints JSON lines; exits non-zero without a CUDA device or if a variant
does not build or its output differs.

The variants are text edits of the current sources: an edit that no longer
applies fails loudly, and the script then describes an earlier design.
"""
import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from alfalfa_tpu_torch import _build  # noqa: E402
from alfalfa_tpu_torch.ops import enc_decide_cuda, enc_inter_cuda, \
    enc_intra_cuda, enc_intra_fixup_cuda, intra_cuda, lf_cuda, rebase_cuda, \
    sixtap_cuda, wavefront, wavefront_cuda  # noqa: E402
from alfalfa_tpu_torch.tools import poison_check  # noqa: E402

OUT = os.path.join(REPO, "build", "ablation")
SOURCES = ("enc_inter", "enc_decide")


def rep(s, old, new):
    if old not in s:
        raise SystemExit("the ablation edit no longer applies: %r" % old[:60])
    return s.replace(old, new)


def no_pred(s):
    """Every prediction through the full two-pass six-tap."""
    s = rep(s, "sad[k] = abs(o - sixtap_pred(", "sad[k] = abs(o - sixtap_pixel(")
    return rep(s, "diff = o - sixtap_pred(", "diff = o - sixtap_pixel(")


def no_pred_encode(s):
    s = rep(s, "s.p16[tid] = sixtap_pred(", "s.p16[tid] = sixtap_pixel(")
    return rep(s, "s.pc[pl][k] = sixtap_pred(", "s.pc[pl][k] = sixtap_pixel(")


def no_centre(s):
    """The diamond's centre filtered again at every step."""
    s = rep(s, "if (k == 2 && known) continue;", "")
    return rep(s, "if (lane == 2 && known) {", "if (false) {")


def global_tables(s):
    """The cost tables read from device memory."""
    s = rep(s, "__shared__ int d##_sadcost[256], d##_mvcost[4096], "
               "d##_pcost[256],      \\\n      d##_mvc2p[24], d##_nb",
            "__shared__ int d##_nb")
    s = rep(s, "ChainShared d{d##_sadcost, d##_mvcost, d##_pcost, d##_mvc2p, "
               "d##_nb,",
            "ChainShared d{*(int(*)[256])a.t.sadcost, "
            "*(int(*)[4096])a.t.mvcost, *(int(*)[256])a.t.pcost, "
            "*(int(*)[24])a.t.mvc2p, d##_nb,")
    return rep(s, "  for (int i = tid; i < 4096; i += blockDim.x) "
                  "d.mvcost[i] = t.mvcost[i];\n  d.sadcost[tid] = "
                  "t.sadcost[tid];\n  d.pcost[tid] = t.pcost[tid];\n  if "
                  "(tid < 24) d.mvc2p[tid] = t.mvc2p[tid];", "  (void)tid;")


TWO_BARRIERS = '''      __shared__ int abl_pick;
      __shared__ long long abl_best;
      if (threadIdx.x == 0) {
        long long best0 = 0x7fffffffffffffffll;
        int bk0 = 0;
        for (int k = 0; k < 5; ++k) {
          const int sx = ox + st * site_dx(k), sy = oy + st * site_dy(k);
          if (abs(sx) > MV_LIMIT || abs(sy) > MV_LIMIT) continue;
          long long cost;
          if (k == 2 && known) {
            cost = centre;
          } else {
            int dist = 0;
            for (int w = 0; w < 8; ++w) dist += d.sad[buf][w][k];
            const int cx = abs(clampi(sx >> 2, -255, 255));
            const int cy = abs(clampi(sy >> 2, -255, 255));
            const long long rate =
                ((long long)(d.sadcost[cy] + d.sadcost[cx]) * sadw + 128) >> 8;
            cost = ((128 + rate) >> 8) + dist;
          }
          if (cost < best0) { best0 = cost; bk0 = k; }
        }
        abl_pick = bk0;
        abl_best = best0;
      }
      __syncthreads();
      const int bk = abl_pick;
      const long long best = abl_best;
      for (int k = 0; k < 5; ++k) {
        const int sx = ox + st * site_dx(k), sy = oy + st * site_dy(k);
        if (abs(sx) <= MV_LIMIT && abs(sy) <= MV_LIMIT) {
          int tx = sx + brx, ty = sy + bry;
          clamp_mv(tx, ty, r, c, R, C);
          ++sites;
          taps += luma_taps(tx & 7, ty & 7);
        }
      }
'''


def two_barriers(s):
    """The parent's diamond step: thread 0 takes the pick between two
    barriers."""
    i = s.index("      // lane k < 5 scores site k; a site out of bounds")
    j = s.index("      centre = best;\n")
    return s[:i] + TWO_BARRIERS + s[j:]


def no_prefetch_k8(s):
    """The originals loaded from the planes, not copied ahead."""
    return rep(s, "mb_load(P, s, r, c, s_src[c & 1]);", "mb_load(P, s, r, c);")


def no_prefetch_k9(s):
    return rep(s, "const int o = s_src[c & 1][tid];",
               "const int o = a.oy[(size_t)Y * W + X];")


SEPARABLE = '''      int sad[5];
      bool two_d = false;
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const int sx = ox + st * site_dx(k), sy = oy + st * site_dy(k);
        if (k == 2 && known) continue;
        if (abs(sx) > MV_LIMIT || abs(sy) > MV_LIMIT) continue;
        int tx = sx + brx, ty = sy + bry;
        clamp_mv(tx, ty, r, c, R, C);
        if ((tx & 7) == 0 || (ty & 7) == 0) continue;
        two_d = true;
        const int y0 = Y - (threadIdx.x >> 4) + (ty >> 3) - 2;
        const int x0 = X - (threadIdx.x & 15) + (tx >> 3) - 2;
        for (int i = threadIdx.x; i < 336; i += 256) {
          const uint8_t* row = ly + (size_t)clampi(y0 + (i >> 4), 0, H - 1) * W;
          int win[6];
#pragma unroll
          for (int q = 0; q < 6; ++q)
            win[q] = row[clampi(x0 + (i & 15) + q, 0, W - 1)];
          abl_hp[k][i] = (uint8_t)sixtap(win, 1, tx & 7);
        }
      }
      if (two_d) __syncthreads();
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const int sx = ox + st * site_dx(k), sy = oy + st * site_dy(k);
        sad[k] = 0;
        if (k == 2 && known) continue;
        if (abs(sx) <= MV_LIMIT && abs(sy) <= MV_LIMIT) {
          int tx = sx + brx, ty = sy + bry;
          clamp_mv(tx, ty, r, c, R, C);
          const int pred = (tx & 7) && (ty & 7)
              ? sixtap(&abl_hp[k][threadIdx.x], 16, ty & 7)
              : sixtap_pred(ly, H, W, Y, X, tx, ty);
          sad[k] = abs(o - pred);
        }
        sad[k] = warp_sum(sad[k]);
      }'''


def separable(s):
    """Tried and not kept: the 2-D sites' horizontal passes computed once a
    window position into shared memory (a second barrier a step)."""
    i = s.index("      int sad[5];\n#pragma unroll")
    j = s.index("      if (lane == 0) {\n#pragma unroll\n        for (int k = 0;"
                " k < 5; ++k) d.sad[buf][warp][k] = sad[k];")
    s = s[:i] + SEPARABLE + "\n" + s[j:]
    return rep(s, "  int buf = 0;\n",
               "  int buf = 0;\n  __shared__ uint8_t abl_hp[5][336];\n")


def clocked(s):
    """Thread 0's clock64() per phase of K8, summed over blocks."""
    s = rep(s, "struct InterArgs {", '''__device__ unsigned long long g_phase[8];
extern "C" int phase_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
}
extern "C" int phase_zero() {
  unsigned long long z[8] = {0};
  return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z));
}
struct InterArgs {''')
    s = rep(s, "  for (int c = 0; c < C; ++c) {\n",
            "  long long ph[6] = {0, 0, 0, 0, 0, 0}, t_ = clock64(), t2_;\n"
            "#define TICK(k) if (tid == 0) { t2_ = clock64(); ph[k] += t2_ - "
            "t_; t_ = t2_; }\n  for (int c = 0; c < C; ++c) {\n")
    s = rep(s, "row_wait(prog - 1, min(c + lag, C));\n",
            "row_wait(prog - 1, min(c + lag, C));\n    TICK(0)\n")
    s = rep(s, "    // ---- NEWMV, then the four candidates",
            "    TICK(1)\n    // ---- NEWMV, then the four candidates")
    s = rep(s, "    // the search's vector plus the best one, not clamped "
               "again\n    const int nx",
            "    TICK(2)\n    const int nx")
    s = rep(s, "    // ---- encode the winner ----\n",
            "    TICK(3)\n    // ---- encode the winner ----\n")
    s = rep(s, "    const int wm = s.dec[0], um = s.dec[1];\n",
            "    TICK(4)\n    const int wm = s.dec[0], um = s.dec[1];\n")
    return rep(s, "    if (tid == 0) row_publish(prog, c + 1);\n  }\n",
               "    if (tid == 0) row_publish(prog, c + 1);\n    TICK(5)\n  }\n"
               "  if (tid == 0)\n    for (int k = 0; k < 6; ++k)\n"
               "      atomicAdd(&g_phase[k], (unsigned long long)ph[k]);\n")


# variant: {file: edit}
VARIANTS = {
    "kept": {},
    "no_pred": {"enc_inter_chain.cuh": no_pred, "enc_inter.cu": no_pred_encode},
    "two_barriers": {"enc_inter_chain.cuh": two_barriers},
    "no_centre": {"enc_inter_chain.cuh": no_centre},
    "global_tables": {"enc_inter_chain.cuh": global_tables},
    "no_prefetch": {"enc_inter.cu": no_prefetch_k8,
                    "enc_decide.cu": no_prefetch_k9},
    "separable": {"enc_inter_chain.cuh": separable},
    "clocked": {"enc_inter.cu": clocked},
}
PHASES = ("wait", "load_screen_census", "search", "candidates", "encode",
          "outputs_publish")

# ---- K7: thread 0's clock per phase, on this checkout's sources or a
# parent's (the edits take either form of enc_intra.cu)

# thread 0's phases; where the whole-mode and chroma steps run beside B_PRED
# (warps 1-7), thread 32 clocks those and thread 0 the wait at the join
K7_PHASES = ("wait", "load", "bpred_search", "bpred_chain", "whole_costs",
             "y2_path", "chroma", "join_wait", "outputs_publish")

K7_TICK = '''#include "trellis.cuh"

__device__ unsigned long long g_k7phase[16];
extern "C" int k7_phase_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_k7phase, sizeof(g_k7phase));
}
extern "C" int k7_phase_zero() {
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(g_k7phase, z, sizeof(z));
}
// thread ``who``: the cycles since its last tick go to phase k (k < 0:
// none)
template <int who>
__device__ __forceinline__ void ph_clock(int k) {
  __shared__ long long ph_t;
  if (threadIdx.x == who) {
    const long long t = clock64();
    if (k >= 0) atomicAdd(&g_k7phase[k], (unsigned long long)(t - ph_t));
    ph_t = t;
  }
}
#define ph_tick ph_clock<0>
#define ph_side ph_clock<32>
'''


def rep_any(s, pairs):
    """The first (old, new) of ``pairs`` whose old text ``s`` holds."""
    for old, new in pairs:
        if old in s:
            return s.replace(old, new)
    raise SystemExit("the ablation edit no longer applies: %r" % pairs[0][0][:60])


def clocked_k7_steps(s):
    """enc_mb_device.cuh: ticks around the B_PRED search and chain and
    after each later step of intra_mb."""
    s = rep(s, '#include "trellis.cuh"\n', K7_TICK)
    s = rep_any(s, [("      s.bm[sb] = best;\n",
                     "      ph_tick(2);\n      s.bm[sb] = best;\n"),
                    ("    if (active) {\n      b_rate += rates[best];\n",
                     "    ph_tick(2);\n    if (active) {\n      b_rate += "
                     "rates[best];\n")])
    s = rep_any(s, [("    __syncthreads();\n  }\n  if (tid == 0) s.bcost = ",
                     "    __syncthreads();\n    ph_tick(3);\n  }\n"
                     "  if (tid == 0) s.bcost = "),
                    ("    __syncwarp();\n  }\n  b_rate += ",
                     "    __syncwarp();\n    ph_tick(3);\n  }\n"
                     "  b_rate += ")])
    if "whole_luma_costs<SideTeam>" in s:
        # the steps beside B_PRED: thread 32's clock; thread 0's at the join
        s = rep(s, "    if (!screened) whole_luma_costs<SideTeam>(a, s, mbc);\n",
                "    ph_side(-1);\n    if (!screened) "
                "whole_luma_costs<SideTeam>(a, s, mbc);\n    ph_side(4);\n")
        s = rep(s, "    y2_path<WholePred, SideTeam>(a, s, trellis, "
                   "WholePred{s.dec[0]});\n",
                "    y2_path<WholePred, SideTeam>(a, s, trellis, "
                "WholePred{s.dec[0]});\n    ph_side(5);\n")
        return rep(s, "                                     WholePred{s.dec[1]});"
                      "\n  }\n  __syncthreads();\n",
                   "                                     WholePred{s.dec[1]});"
                   "\n    ph_side(6);\n  }\n  __syncthreads();\n  ph_tick(7);\n")
    s = rep(s, "  whole_luma_costs(a, s, mbc, true);\n",
            "  whole_luma_costs(a, s, mbc, true);\n  ph_tick(4);\n")
    s = rep(s, "  if (!s.dec[0]) y2_path(a, s, trellis, WholePred{s.dec[1]});\n",
            "  if (!s.dec[0]) y2_path(a, s, trellis, WholePred{s.dec[1]});\n"
            "  ph_tick(5);\n")
    return rep(s, "  chroma_code(a, s, r, c, trellis, WholePred{s.dec[2]});\n}",
               "  chroma_code(a, s, r, c, trellis, WholePred{s.dec[2]});\n"
               "  ph_tick(6);\n}")


def clocked_k7(s):
    """enc_intra.cu: ticks after the row wait, the load and the outputs."""
    s = rep(s, "  MB_SHARED(s);\n", "  MB_SHARED(s);\n  ph_tick(-1);\n")
    if "row_wait(" in s:
        s = rep(s, "row_wait(prog - 1, min(c + lag, C));\n",
                "row_wait(prog - 1, min(c + lag, C));\n    ph_tick(0);\n")
    s = rep_any(s, [("  mb_load(P, s, r, c);\n",
                     "  mb_load(P, s, r, c);\n  ph_tick(1);\n"),
                    ("  mb_load(P, s, r, c, staged);\n",
                     "  mb_load(P, s, r, c, staged);\n  ph_tick(1);\n")])
    return rep_any(s, [("    if (tid == 0) row_publish(prog, c + 1);\n",
                        "    if (tid == 0) row_publish(prog, c + 1);\n"
                        "    ph_tick(8);\n"),
                       ("\n  }\n}\n\n// Enqueue the 2*(R-1) + C",
                        "\n  }\n  ph_tick(8);\n}\n\n// Enqueue the 2*(R-1) + C")])


def write_variants(variants):
    for name, edits in variants.items():
        d = os.path.join(OUT, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC_DIR, d)
        for fn, edit in edits.items():
            p = os.path.join(d, fn)
            with open(p) as fh:
                text = edit(fh.read())
            with open(p, "w") as fh:
                fh.write(text)


def build(jobs):
    """[(so path, .cu path)] -> compiler output of each, all at once."""
    procs = [(so, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)) for so, cu in jobs]
    logs = {}
    for so, p in procs:
        out = p.communicate()[0].decode(errors="replace")
        if p.returncode:
            raise SystemExit("nvcc failed for %s:\n%s" % (so, out[-4000:]))
        logs[so] = [l.strip() for l in out.splitlines()
                    if "registers" in l or "spill" in l]
    return logs


# each library's C entry and the argument types its wrapper gives it
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
ENTRIES = {
    "enc_inter": ("encode_inter_frame_launch",
                  [_PTR] * 24 + [_INT] * 4 + [_PTR, _INT]),
    "enc_decide": ("decide_inter_frame_launch",
                   [_PTR] * 9 + [_INT] * 3 + [_PTR, _INT]),
    "enc_intra": ("encode_kf_frame_launch", enc_intra_cuda.ARGTYPES),
    "wavefront": ("loop_filter_launch", lf_cuda.ARGTYPES),
}


def entry(name, src):
    """The C entry of variant ``name``'s ``src`` library, typed as the
    wrapper types it."""
    fn, types = ENTRIES[src]
    f = getattr(ctypes.CDLL(os.path.join(OUT, name, "lib%s.so" % src)), fn)
    f.restype = ctypes.c_int
    f.argtypes = list(types) + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    return f


# the kernels the redesign of K4 and the six-tap kernel holds to the
# parent's machine code: K1's (its reconstruction step moved into helpers
# K4 calls too) and K5's in the library they share with K4, and K7's,
# K8's, K9's and K10's libraries
SAME_SASS = {"wavefront": ("wave_row_kernel", "lf_row_kernel"),
             "enc_intra": None, "enc_inter": None, "enc_decide": None,
             "enc_intra_fixup": None}


def sass_functions(so, cuobjdump):
    """{function name: [instruction lines]} of a library's machine code."""
    funcs, name = {}, None
    for line in subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                               text=True, check=True).stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            funcs[name] = []
        elif name is not None and "/*" in line:
            funcs[name].append(line)
    return funcs


def _instruction(line):
    """A machine-code line without its address and encoding comments, and
    with the offsets into the user constant bank (c[0x3], where __constant__
    tables land) written as *: they move when a library's tables do."""
    return re.sub(r"c\[0x3\]\[0x[0-9a-f]+\]", "c[0x3][*]",
                  re.sub(r"/\*[^*]*\*/", "", line)).strip()


def same_sass(parent):
    """The machine code of SAME_SASS's kernels from ``parent``'s sources
    and from this checkout's: {kernel: (instructions parent, here,
    identical, instructions that differ beyond constant-bank offsets)}."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = {}
    for src, names in SAME_SASS.items():
        jobs = [(os.path.join(OUT, "%s_%s.so" % (tag, src)),
                 os.path.join(d, src + ".cu"))
                for tag, d in (("parent", os.path.join(
                    parent, "alfalfa_tpu_torch", "csrc")),
                    ("here", _build.CSRC_DIR))]
        build(jobs)
        funcs = [sass_functions(so, cuobjdump) for so, _ in jobs]
        for fn in sorted(funcs[0]):
            if names is None or any(n in fn for n in names):
                a, b = funcs[0][fn], funcs[1].get(fn, [])
                na = [x for x in map(_instruction, a) if x]
                nb = [x for x in map(_instruction, b) if x]
                out[fn] = (len(a), len(b), a == b,
                           sum(x != y for x, y in zip(na, nb))
                           + abs(len(na) - len(nb)))
    return out


# ---- K7 and K5: each step of their redesign undone

THREAD_CHAIN = '''__device__ __forceinline__ void bpred_candidate(const MbPlanes& a,
                                                MbShared& s, const int* mbc,
                                                const int* bcost,
                                                bool contextual, bool trellis) {
  __shared__ int abl_pred[10][16], abl_sse[10];
  const int tid = threadIdx.x;
  const int ydc = a.q[0], yac = a.q[1];
  long long b_rate = mbc[B_PRED], b_dist = 0;  // thread 0's
  for (int sb = 0; sb < 16; ++sb) {
    const int sr = sb >> 2, sc = sb & 3;
    if (tid < 160) {
      const int m = tid >> 4, p = tid & 15, ly = p >> 2, lx = p & 3;
      int E[13];
      // the right-most sub-block takes its above-right from the row above
      // the macroblock in every sub-block row
      const int arow = sc == 3 ? 0 : sr * 4;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        E[3 - k] = s.t[sr * 4 + 1 + k][sc * 4];
        E[5 + k] = s.t[sr * 4][sc * 4 + 1 + k];
        E[9 + k] = s.t[arow][sc * 4 + 5 + k];
      }
      E[4] = s.t[sr * 4][sc * 4];
      const int pred = bpred_pixel(m, E, ly, lx);
      const int diff = s.o[(sr * 4 + ly) * 16 + sc * 4 + lx] - pred;
      int v = diff * diff;
      abl_pred[m][p] = pred;
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      if (p == 0) abl_sse[m] = v;
    }
    __syncthreads();
    if (tid == 0) {
      const int* rates = bcost;
      if (contextual) {
        const int above = sr ? s.bm[sb - 4] : s.nbm[sc];
        const int left = sc ? s.bm[sb - 1] : s.nbm[4 + sr];
        rates = bcost + (above * 10 + left) * 10;
      }
      int best = 0;
      long long best_cost = rdcost(rates[0], abl_sse[0], a.rm, a.dm);
      for (int m = 1; m < 10; ++m) {
        const long long cost = rdcost(rates[m], abl_sse[m], a.rm, a.dm);
        if (cost < best_cost) { best_cost = cost; best = m; }
      }
      s.bm[sb] = best;
      b_rate += rates[best];
      b_dist += abl_sse[best];
      int res[16], co[16], qc[16];
      for (int p = 0; p < 16; ++p)
        res[p] = s.o[(sr * 4 + (p >> 2)) * 16 + sc * 4 + (p & 3)] - abl_pred[best][p];
      fdct4x4(res, co);
      if (trellis) {
        const int up = sr ? s.bnz[sb - 4] : s.ctx[sc];
        const int lf = sc ? s.bnz[sb - 1] : s.ctx[4 + sr];
        s.bnz[sb] = trellis_quantize(co, ydc, yac, a.tc + BT_Y_WITHOUT_Y2 * 576,
                                     a.vcost, up + lf, 0, a.rm, a.dm, qc);
      } else {
        quantize4x4(co, ydc, yac, qc);
      }
      for (int p = 0; p < 16; ++p) s.bco[sb][p] = qc[p];
      dequantize4x4(qc, ydc, yac, co);
      idct4x4(co, res);
      for (int p = 0; p < 16; ++p)
        s.t[sr * 4 + 1 + (p >> 2)][sc * 4 + 1 + (p & 3)] =
            clampi(abl_pred[best][p] + res[p], 0, 255);
    }
    __syncthreads();
  }
  if (tid == 0) s.bcost = rdcost(b_rate, b_dist, a.rm, a.dm);
}
'''


def thread_chain(s):
    """The parent's B_PRED candidate: 160 threads predict, thread 0 picks
    and runs each sub-block's transform chain between two barriers (with
    no_overlap: its barriers are the whole block's)."""
    i = s.index("__device__ __forceinline__ void bpred_candidate(")
    j = s.index("// Where the luma and chroma chains take their prediction")
    return s[:i] + THREAD_CHAIN + "\n" + s[j:]


def raster_chain(s):
    """The B_PRED sub-blocks one a step in raster order, both halves of warp
    0 alike, not two a step along the diagonals 2 sr + sc."""
    return rep(s, """  for (int d = 0; d < 10; ++d) {
    // half h takes the (h+1)-th sub-block of diagonal d, in order of rows
    const int first = d < 3 ? 0 : (d - 2) >> 1;
    const bool active = first + h <= 3 && d - 2 * (first + h) >= 0;
    const int sr = active ? first + h : first, sc = d - 2 * sr;""",
               """  for (int d = 0; d < 16; ++d) {
    const bool active = h == 0;
    const int sr = d >> 2, sc = d & 3;""")


def device_tables(s):
    """K7's cost tables read from device memory, not staged in shared
    memory."""
    s = rep(s, "    P.tc = tab_tc;\n    P.vcost = tab_vcost;\n", "")
    return rep(s, "  t.mbc = tab_mbc;\n  t.bcost = tab_bcost;\n", "")


def in_kernel(head, edit):
    """``edit`` applied to the body of the kernel whose definition starts
    with ``head`` alone (K1's and K5's kernels have lines of the same
    text)."""
    def edited(s):
        i = s.index(head)
        j = s.index("\n}\n", i) + 3
        return s[:i] + edit(s[i:j]) + s[j:]
    return edited


def in_k5(edit):
    return in_kernel("lf_row_kernel(LfRowArgs a) {", edit)


def k5_no_prefetch(s):
    """K5 loads a macroblock's input row and limits when it reaches it, not
    one macroblock ahead."""
    s = rep(s, "  fetch(0);\n", "")
    s = rep(s, "    const int x0 = c * S;\n    uint32_t px[4]",
            "    const int x0 = c * S;\n    fetch(c);\n    uint32_t px[4]")
    return rep(s, "    if (c + 1 < C) fetch(c + 1);\n", "")


def no_overlap(s):
    """The intra macroblock's steps one after another on the whole block
    (the parent's intra_mb, K7's and K8's), not the whole-mode and chroma
    chains beside B_PRED; the whole mode's reconstruction copied to s.wt,
    where the callers read it."""
    i = s.index("  if (threadIdx.x < 32) {\n    bpred_candidate(")
    j = s.index("  return s.bcost < s.wcost;\n}", i)
    return s[:i] + """  bpred_candidate(a, s, mbc, bcost, contextual, trellis);
  if (screened) __syncthreads();
  else whole_luma_costs(a, s, mbc);
  const bool use_b = s.bcost < s.wcost;
  if (!use_b) {
    y2_path(a, s, trellis, WholePred{s.dec[0]});
    __syncthreads();
    const int py = threadIdx.x >> 4, px = threadIdx.x & 15;
    s.wt[py][px] = s.t[1 + py][1 + px];
  }
  chroma_mode(s);
  chroma_code(a, s, r, c, trellis, WholePred{s.dec[1]});
  __syncthreads();
  return use_b;
}""" + s[j + len("  return s.bcost < s.wcost;\n}"):]


def one_form(s):
    """K7 as one kernel for one-pass and two-pass (the form that tests the
    token costs at run time), not two instantiations."""
    return rep(s, "enc_kf_row_kernel<false><<<", "enc_kf_row_kernel<true><<<")


def serial_walks(s):
    """The parent's trellis of the chained blocks: thread 0 walks the 16
    whole-luma blocks, threads 0 and 1 U's and V's four, one after another
    with the one-call form."""
    s = rep(s, """      const TrellisNodes n = trellis_backward(s.wco[tid], ydc, yac, tcy,
                                              a.vcost, 1, a.rm, a.dm);
      s.tsel[tid] = trellis_bits(n, tcy, 1, a.rm, a.dm, end, levels);
""", "")
    s = rep(s, """      const TrellisNodes n = trellis_backward(s.uvco[tid], uvdc, uvac, tcu,
                                              a.vcost, 0, a.rm, a.dm);
      s.tsel[tid] = trellis_bits(n, tcu, 0, a.rm, a.dm, end, levels);
""", "")
    i = s.index("  if (trellis && tid < 16) {\n    // the walk of the level")
    j = s.index("  if (tid == (trellis ? 32 : 0)) {")
    s = s[:i] + """  if (trellis && tid == 0) {
    for (int b = 0; b < 16; ++b) {
      const int up = b >> 2 ? s.wnz[b - 4] : s.ctx[b & 3];
      const int lf = b & 3 ? s.wnz[b - 1] : s.ctx[4 + (b >> 2)];
      s.wnz[b] = trellis_quantize(s.wco[b], ydc, yac, tcy, a.vcost, up + lf,
                                  1, a.rm, a.dm, s.wco[b]);
    }
  }
""" + s[j:]
    i = s.index("  if (trellis && tid < 8) {\n    // U and V")
    j = s.index("  Team::sync();\n", i)
    return s[:i] + """  if (trellis && tid < 2) {
    const int pl = tid;
    for (int b = 0; b < 4; ++b) {
      const int k = 4 * pl + b;
      const int up = b >> 1 ? s.uvnz[k - 2] : s.ctx[8 + 4 * pl + (b & 1)];
      const int lf = b & 1 ? s.uvnz[k - 1] : s.ctx[10 + 4 * pl + (b >> 1)];
      s.uvnz[k] = trellis_quantize(s.uvco[k], uvdc, uvac, tcu, a.vcost,
                                   up + lf, 0, a.rm, a.dm, s.uvco[k]);
    }
  }
""" + s[j:]


def diagonal_k7(s):
    """K7 as the parent launched it: one launch per diagonal d = 2r + c, a
    block per macroblock, the originals loaded from the planes."""
    s = rep(s, "// Launch the persistent kernel for one frame", """template <bool kTrellis>
__global__ void __launch_bounds__(256) abl_kf_diag(EncArgs a, int d,
                                                  int r_lo) {
  const int r = r_lo + blockIdx.x, c = d - 2 * r;
  const MbPlanes P = a.p;
  MB_SHARED(s);
  kf_mb<kTrellis>(a, P, s, r, c, nullptr);
}

// Launch the persistent kernel for one frame""")
    return rep(s, """  if (tc != nullptr)
    enc_kf_row_kernel<true><<<R, 256, 0, (cudaStream_t)stream>>>(a);
  else
    enc_kf_row_kernel<false><<<R, 256, 0, (cudaStream_t)stream>>>(a);
  *n_launched = 1;""", """  int issued = 0;
  for (int d = 0; d < 2 * (R - 1) + C; ++d) {
    const int lo = d - C + 1, r_lo = lo > 0 ? (lo + 1) / 2 : 0;
    const int n = (d / 2 < R - 1 ? d / 2 : R - 1) - r_lo + 1;
    if (n <= 0) continue;
    if (tc != nullptr)
      abl_kf_diag<true><<<n, 256, 0, (cudaStream_t)stream>>>(a, d, r_lo);
    else
      abl_kf_diag<false><<<n, 256, 0, (cudaStream_t)stream>>>(a, d, r_lo);
    ++issued;
  }
  *n_launched = issued;""")


def k5_whole_wait(s):
    """K5 waits on the row above before a macroblock's vertical edges too,
    not only before its horizontal ones."""
    s = rep(s, """    if (on)
      lf_filter_window(s_y, s_u, s_v, lane, do_left, do_top, p[5] == 0, p[1],
                       p[2], p[3], p[4], true, false);
    if (lane == 0 && r > 0) row_wait(prog - 1, min(c + lag, C));
    __syncwarp();
""", """    if (lane == 0 && r > 0) row_wait(prog - 1, min(c + lag, C));
    __syncwarp();
    if (on)
      lf_filter_window(s_y, s_u, s_v, lane, do_left, do_top, p[5] == 0, p[1],
                       p[2], p[3], p[4], true, false);
""")
    return s


# variant: {file: edit}, built from SOURCES_K7
VARIANTS_K7 = {
    "kept": {},
    "thread_chain": {"enc_mb_device.cuh":
                     lambda s: no_overlap(thread_chain(s))},
    "raster_chain": {"enc_mb_device.cuh": raster_chain},
    "no_overlap": {"enc_mb_device.cuh": no_overlap},
    "one_form": {"enc_intra.cu": one_form},
    "device_tables": {"enc_intra.cu": device_tables},
    "serial_walks": {"enc_mb_device.cuh": serial_walks},
    "diagonal_k7": {"enc_intra.cu": diagonal_k7},
    "k5_no_prefetch": {"wavefront_device.cuh": in_k5(k5_no_prefetch)},
    "k5_whole_wait": {"wavefront_device.cuh": in_k5(k5_whole_wait)},
}
SOURCES_K7 = ("enc_intra", "wavefront", "enc_inter")


# ---- K1 and K10: each step of their redesign undone

def k1_serial_bpred(s):
    """K1's B_PRED sub-blocks one a step in raster order, both halves of
    the warp alike, not two a step along the diagonals 2 sr + sc."""
    return rep(s, """  for (int d = 0; d < 10; ++d) {
    // half h takes the (h+1)-th sub-block of diagonal d, in order of rows
    const int first = d < 3 ? 0 : (d - 2) >> 1;
    const bool active = first + h <= 3 && d - 2 * (first + h) >= 0;
    const int sr = active ? first + h : first, sc = d - 2 * sr;""",
               """  for (int d = 0; d < 16; ++d) {
    const bool active = h == 0;
    const int sr = d >> 2, sc = d & 3;""")


def k1_whole_wait(s):
    """K1 filters an inter macroblock's vertical edges after the wait on
    the row above, not before it."""
    s = rep(s, """      lu = (luma ? px[3] : px[1]) >> 24;
      if (on)
        lf_filter_window(s_y, s_u, s_v, lane, do_left, do_top, do_sb, p[5],
                         p[6], p[7], p[8], true, false);
""", """      lu = (luma ? px[3] : px[1]) >> 24;
""")
    return rep(s, """    if (lane == 0 && r > 0) row_wait(prog - 1, min(c + lag, C));
    __syncwarp();
""", """    if (lane == 0 && r > 0) row_wait(prog - 1, min(c + lag, C));
    __syncwarp();
    if (!intra && on)
      lf_filter_window(s_y, s_u, s_v, lane, do_left, do_top, do_sb, p[5],
                       p[6], p[7], p[8], true, false);
""")


def k10_every(s):
    """K10 visits every macroblock of its row, encoding the intra ones, and
    publishes after each, not once per run of inter macroblocks."""
    s = rep(s, "k < C && md[(size_t)k * DECIDE_WORDS] == 0", "k < C")
    return rep(s, "    fixup_mb(a, P, s,",
               "    if (md[(size_t)c * DECIDE_WORDS] == 0) fixup_mb(a, P, s,")


def k10_publish_every(s):
    """k10_every, waiting only before an intra macroblock."""
    return rep(k10_every(s), "if (tid == 0 && r > 0) row_wait(",
               "if (tid == 0 && r > 0 && md[(size_t)c * DECIDE_WORDS] == 0) "
               "row_wait(")


K1_PHASES = ("before_wait", "wait", "loads", "intra_rows", "bpred_chain",
             "intra_pack", "intra_vertical", "horizontal", "stores_publish")


def k1_clocked_globals(s):
    """The phase counters of k1_clocked (K1_PHASES, then the intra and the
    B_PRED macroblocks counted) and their C entries."""
    return rep(s, '#include "row_sched.cuh"\n', '''#include "row_sched.cuh"

__device__ unsigned long long g_k1phase[16];
extern "C" int k1_phase_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_k1phase, sizeof(g_k1phase));
}
extern "C" int k1_phase_zero() {
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(g_k1phase, z, sizeof(z));
}
#define K1_TICK(k) if (lane == 0) { t2_ = clock64(); ph_[k] += t2_ - t_; t_ = t2_; }
''')


def k1_clocked(s):
    """Lane 0's clock64() per phase of K1's macroblock step (K1_PHASES),
    summed over the warps; the intra phases over intra macroblocks only,
    the chain over B_PRED ones."""
    s = rep(s, "  fetch(0);\n",
            "  long long ph_[12] = {0}, t_ = clock64(), t2_;\n"
            "  int n_intra_ = 0, n_bpred_ = 0;\n  fetch(0);\n")
    s = rep(s, "    if (lane == 0 && r > 0) row_wait(prog - 1, min(c + lag, C));\n"
               "    __syncwarp();\n",
            "    K1_TICK(0)\n"
            "    if (lane == 0 && r > 0) row_wait(prog - 1, min(c + lag, C));\n"
            "    __syncwarp();\n    K1_TICK(1)\n")
    s = rep(s, "    if (intra) {\n      // this macroblock's residual",
            "    K1_TICK(2)\n    n_intra_ += intra;\n    n_bpred_ += bpred;\n"
            "    if (intra) {\n      // this macroblock's residual")
    s = rep(s, "      if (bpred) {\n        __syncwarp();\n",
            "      K1_TICK(3)\n      if (bpred) {\n        __syncwarp();\n")
    s = rep(s, "          for (int k = 0; k < 16; ++k) own[k] = s_t[1 + row][1 + k];\n"
               "        }\n      }\n",
            "          for (int k = 0; k < 16; ++k) own[k] = s_t[1 + row][1 + k];\n"
            "        }\n        K1_TICK(4)\n      }\n")
    s = rep(s, "      lu = (luma ? u[3] : u[1]) >> 24;\n      __syncwarp();\n",
            "      lu = (luma ? u[3] : u[1]) >> 24;\n      __syncwarp();\n"
            "      K1_TICK(5)\n")
    s = rep(s, "    __syncwarp();\n    if (on)\n      lf_filter_window(s_y, s_u, "
               "s_v, lane, do_left, do_top, do_sb, p[5],\n                       "
               "p[6], p[7], p[8], false, true);\n",
            "    __syncwarp();\n    K1_TICK(6)\n    if (on)\n      "
            "lf_filter_window(s_y, s_u, s_v, lane, do_left, do_top, do_sb, "
            "p[5],\n                       p[6], p[7], p[8], false, true);\n"
            "    K1_TICK(7)\n")
    return rep(s, "    if (lane == 0) row_publish(prog, c + 1);\n  }\n}",
               "    if (lane == 0) row_publish(prog, c + 1);\n    K1_TICK(8)\n"
               "  }\n  if (lane == 0) {\n    for (int k = 0; k < 9; ++k)\n"
               "      atomicAdd(&g_k1phase[k], (unsigned long long)ph_[k]);\n"
               "    atomicAdd(&g_k1phase[14], (unsigned long long)n_intra_);\n"
               "    atomicAdd(&g_k1phase[15], (unsigned long long)n_bpred_);\n"
               "  }\n}")


K1_HEAD = "wave_row_kernel(WaveRowArgs a) {"
# variant: {file: edit}, built from SOURCES_K1
VARIANTS_K1 = {
    "kept": {},
    "k1_serial_bpred": {"wavefront_device.cuh": k1_serial_bpred},
    "k1_whole_wait": {"wavefront_device.cuh": in_kernel(K1_HEAD,
                                                        k1_whole_wait)},
    "k10_publish_every": {"enc_intra_fixup.cu": k10_publish_every},
    "k10_wait_every": {"enc_intra_fixup.cu": k10_every},
    "k1_clocked": {"wavefront_device.cuh": lambda s: in_kernel(
        K1_HEAD, k1_clocked)(k1_clocked_globals(s))},
}
SOURCES_K1 = ("wavefront", "enc_intra_fixup")


def lib_entry(path, fn, types):
    """The C entry ``fn`` of the library ``path``, typed as a wrapper types
    it (``types``, then the stream and the launch count)."""
    f = getattr(ctypes.CDLL(path), fn)
    f.restype = ctypes.c_int
    f.argtypes = list(types) + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    return f


def k1_k10_cases():
    """[(wrapper, case, args)]: K1 on the GOP decoder's 720p G=16 frames,
    K10 on the fast path's 720p frame 1, pair and scene cut and 176x144."""
    ivf = cs.IVFReader(cs.CLIP)
    kept = cs.real_kernel_inputs([ivf.frame(i) for i in (0, 1)], ivf.width,
                                 ivf.height, cs.G)
    out = [(wavefront_cuda.wavefront_decode, "k1_" + k, kept["wave_" + k])
           for k in ("inter", "key")]
    sm = cs.decoded_frames(cs.SMALL_CLIP, (0, 1))
    big = cs.decoded_frames(cs.CLIP, (0, 1, 5))
    for case, (a, b, key_qi, qis) in {
            "k10_frame1": (big[0], big[1], 48, [cs.FAST_QI]),
            "k10_pair": (big[0], big[1], cs.FAST_PAIR_KEY_QI,
                         cs.FAST_PAIR_QIS),
            "k10_scene_cut": (big[5], big[0], 48, [cs.FAST_QI]),
            "k10_176x144": (sm[0], sm[1], 48, [cs.FAST_QI])}.items():
        out.append((enc_intra_fixup_cuda.intra_fixup_frame, case,
                    cs.fast_kernel_inputs(a, b, key_qi, qis)[1]))
    return out


def run_k1_k10(card):
    """Time K1 and K10 with each step of their redesign undone
    (VARIANTS_K1), "kept" first and last."""
    write_variants(VARIANTS_K1)
    t0 = time.perf_counter()
    logs = build([(os.path.join(OUT, n, "lib%s.so" % src),
                   os.path.join(OUT, n, src + ".cu"))
                  for n in VARIANTS_K1 for src in SOURCES_K1])
    cs.say("ablation_build", seconds=time.perf_counter() - t0,
           ptxas={os.path.relpath(k, OUT): v for k, v in logs.items()})
    cases = k1_k10_cases()
    saved = wavefront_cuda._entry, enc_intra_fixup_cuda._entry
    ref, ok = {}, True
    try:
        for name in list(VARIANTS_K1) + ["kept"]:
            d = os.path.join(OUT, name)
            wavefront_cuda._entry = lambda d=d: lib_entry(
                os.path.join(d, "libwavefront.so"), "wavefront_decode_launch",
                wavefront_cuda.ARGTYPES)
            enc_intra_fixup_cuda._entry = lambda d=d: lib_entry(
                os.path.join(d, "libenc_intra_fixup.so"),
                "intra_fixup_frame_launch", enc_intra_fixup_cuda.ARGTYPES)
            ms, equal = {}, {}
            for fn, case, a in cases:
                out = fn(*a)
                ref.setdefault(case, out)
                equal[case] = all(torch.equal(x, y)
                                  for x, y in zip(out, ref[case]))
                ms[case] = cs.time_ms(lambda: fn(*a), 20)
            ok &= all(equal.values())
            cs.say("ablation", variant=name, card=card, ms=ms, equal=equal)
            if name == "k1_clocked":
                lib = ctypes.CDLL(os.path.join(d, "libwavefront.so"))
                buf = (ctypes.c_ulonglong * 16)()
                for fn, case, a in cases[:2]:
                    lib.k1_phase_zero()
                    fn(*a)
                    torch.cuda.synchronize()
                    lib.k1_phase_read(buf)
                    n, n_intra, n_bpred = a[6].numel(), buf[14], buf[15]
                    per = [n] * 3 + [max(n_intra, 1)] + [max(n_bpred, 1)] \
                        + [max(n_intra, 1)] * 2 + [n] * 2
                    cs.say("ablation_k1_phases", case=case, card=card,
                           macroblocks=n, intra=n_intra, b_pred=n_bpred,
                           cycles_per_macroblock={
                               p: buf[i] / per[i]
                               for i, p in enumerate(K1_PHASES)})
    finally:
        wavefront_cuda._entry, enc_intra_fixup_cuda._entry = saved
    return ok


# ---- K1's B_PRED step predicting all ten b-modes, under the memory check

def k1_all_modes(s):
    """The B_PRED chain K1 and K4 share predicting all ten b-modes and
    taking the one the bitstream gives, selected with compile-time
    indices as K7's bpred_candidate selects its best (an earlier
    variant, re-created), not one bpred_pixel call of the given mode."""
    return rep(s, "    const int pred = bpred_pixel(mode, E, ly, lx);\n",
               """    int pm[10];
#pragma unroll
    for (int m = 0; m < 10; ++m) pm[m] = bpred_pixel(m, E, ly, lx);
    int pred = pm[0];
#pragma unroll
    for (int m = 1; m < 10; ++m)
      if (mode == m) pred = pm[m];
""")


def k1_all_modes_indexed(s):
    """k1_all_modes with the given mode's prediction read as pm[mode] (a
    run-time index: the array in local memory), the form K7's comment
    warns of."""
    return rep(s, "    const int pred = bpred_pixel(mode, E, ly, lx);\n",
               """    int pm[10];
#pragma unroll
    for (int m = 0; m < 10; ++m) pm[m] = bpred_pixel(m, E, ly, lx);
    const int pred = pm[clampi(mode, 0, 9)];
""")


VARIANTS_ALL_MODES = {
    "k1_all_modes": {"wavefront_device.cuh": k1_all_modes},
    "k1_all_modes_indexed": {"wavefront_device.cuh": k1_all_modes_indexed}}
ALL_MODES_REPEATS = 100
# the variants' fills: the memory check's two, and two mixed bytes
ALL_MODES_PATTERNS = poison_check.PATTERNS + (0xA5, 0x5A)


def all_modes_cases():
    """[(wrapper, plain, case, args)]: K1 on the GOP decoder's 720p G=16 key
    frame and its 176x144 G=3 key frame and interframe (chip_smoke's
    cases), K4 on the single-frame decoder's 720p key frame."""
    ivf = cs.IVFReader(cs.CLIP)
    payloads = [ivf.frame(i) for i in (0, 1)]
    big = cs.real_kernel_inputs(payloads, ivf.width, ivf.height, cs.G)
    small = cs.IVFReader(cs.SMALL_CLIP)
    sm = cs.real_kernel_inputs([small.frame(0), small.frame(1)], small.width,
                               small.height, 3)
    sf = cs.single_frame_kernel_inputs(payloads, ivf.width, ivf.height)
    k1 = (wavefront_cuda.wavefront_decode, wavefront.wavefront_decode_plain)
    return [k1 + ("K1 720p G=16 frame0 key frame", big["wave_key"]),
            k1 + ("K1 176x144 G=3 frame0 key frame", sm["wave_key"]),
            k1 + ("K1 176x144 G=3 frame1 interframe", sm["wave_inter"]),
            (intra_cuda.intra_frame, wavefront.intra_frame_plain,
             "K4 720p frame0 key frame", sf[("intra_frame", 0)][0])]


def run_k1_all_modes(card):
    """K1 (and K4, which shares the chain) with each all-modes B_PRED step
    (VARIANTS_ALL_MODES) against the plain version: ALL_MODES_REPEATS
    plain runs, then the memory check's runs under ALL_MODES_PATTERNS
    (poison_check.check_case: the shared memory and the allocator filled,
    guards around every argument); the kept form the same way, first and
    last, in the same process.  Fails only if the kept form disagrees: the
    variants' readings are the finding."""
    write_variants(VARIANTS_ALL_MODES)
    logs = build([(os.path.join(OUT, n, "libwavefront.so"),
                   os.path.join(OUT, n, "wavefront.cu"))
                  for n in VARIANTS_ALL_MODES])
    cs.say("ablation_build", ptxas={os.path.relpath(k, OUT): v
                                    for k, v in logs.items()})
    saved = wavefront_cuda._entry, intra_cuda._entry
    entries = {"kept": saved}
    for n in VARIANTS_ALL_MODES:
        lib = os.path.join(OUT, n, "libwavefront.so")
        k1 = lib_entry(lib, "wavefront_decode_launch", wavefront_cuda.ARGTYPES)
        k4 = lib_entry(lib, "intra_frame_launch", intra_cuda.ARGTYPES)
        entries[n] = (lambda k1=k1: k1, lambda k4=k4: k4)
    ok = True
    try:
        for fn, plain, case, args in all_modes_cases():
            want = tuple(plain(*args))
            line = {"b_pred_mbs": int(((args[6] == wavefront.B_PRED)
                                       & args[10]).sum().item())}
            for name in ["kept"] + list(VARIANTS_ALL_MODES) + ["kept"]:
                wavefront_cuda._entry, intra_cuda._entry = entries[name]
                errs = []
                for _ in range(ALL_MODES_REPEATS):
                    out = fn(*args)
                    errs.append(max(cs.max_abs_err(x, y)
                                    for x, y in zip(out, want)))
                runs = poison_check.check_case(fn, args, want,
                                               ALL_MODES_PATTERNS)
                r = line.setdefault(name, {"repeats": 0, "repeats_equal": 0,
                                           "repeats_max_abs_err": 0,
                                           "filled": []})
                r["repeats"] += len(errs)
                r["repeats_equal"] += sum(e == 0 for e in errs)
                r["repeats_max_abs_err"] = max([r["repeats_max_abs_err"]]
                                               + errs)
                r["filled"] += [(x["pattern"], x["equal"], x["max_abs_err"],
                                 x["broken_guards"]) for x in runs]
                if name == "kept":
                    ok &= not any(errs) and not poison_check.caught(runs)
            cs.say("ablation_k1_all_modes", case=case, card=card, **line)
    finally:
        wavefront_cuda._entry, intra_cuda._entry = saved
    return ok


# ---- K4 and the six-tap kernel: each step of their redesign undone

K4_HEAD = "intra_row_kernel(IntraRowArgs a) {"


def k4_warps(n):
    """K4's block of ``n`` warps (1: one warp copies and reconstructs all
    three planes)."""
    return lambda s: rep(s, "#define K4_WARPS 4\n", "#define K4_WARPS %d\n" % n)


def k4_publish_every(s):
    """K4 visits every macroblock of its row, the inter ones copied
    already, and publishes after each (waiting only before an intra one),
    not once a run of inter macroblocks."""
    s = rep(s, "  int c = next_intra(mbp, 0, C, lane);\n"
               "  if (tid == 0 && c > 0) row_publish(prog, c);\n",
            "  int c = 0;\n")
    s = rep(s, "    const int cn = next_intra(mbp, c + 1, C, lane);\n",
            "    const int cn = c + 1;\n")
    return rep(s, "    const bool nz = (int16_t)w23 != 0;\n",
               "    const bool nz = (int16_t)w23 != 0;\n"
               "    if ((int16_t)(w23 >> 16) == 0) {\n"
               "      intra_sync<NW>();\n"
               "      if (tid == 0) row_publish(prog, cn);\n"
               "      c = cn;\n      continue;\n    }\n")


K4_PHASES = ("copies", "next_words_left", "wait", "loads", "rows",
             "bpred_chain", "store_publish")

K4_GLOBALS = """#include "row_sched.cuh"

__device__ unsigned long long g_k4phase[16];
extern "C" int k4_phase_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_k4phase, sizeof(g_k4phase));
}
extern "C" int k4_phase_zero() {
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(g_k4phase, z, sizeof(z));
}
#define K4_TICK(k) if (tid == 0) { t2_ = clock64(); ph_[k] += t2_ - t_; t_ = t2_; }
"""


def k4_clocked_globals(s):
    """The phase counters of k4_clocked (K4_PHASES, then the intra and the
    B_PRED macroblocks counted) and their C entries."""
    return rep(s, '#include "row_sched.cuh"\n', K4_GLOBALS)


def k4_clocked(s):
    """Thread 0's clock64() per phase of K4's walk (K4_PHASES), summed
    over the blocks; the copies over all macroblocks, the intra phases over
    intra macroblocks, the chain over B_PRED ones."""
    s = rep(s, "  int* prog = a.rs.progress + g * R + r;\n",
            "  int* prog = a.rs.progress + g * R + r;\n"
            "  long long ph_[8] = {0}, t_ = clock64(), t2_;\n"
            "  int n_intra_ = 0, n_bpred_ = 0;\n")
    s = rep(s, "  __syncthreads();\n  int c = next_intra(",
            "  __syncthreads();\n  K4_TICK(0)\n  int c = next_intra(")
    s = rep(s, "    if (tid == 0 && r > 0) row_wait(",
            "    K4_TICK(1)\n    n_intra_ += 1;\n    n_bpred_ += bpred;\n"
            "    if (tid == 0 && r > 0) row_wait(")
    s = rep(s, "    intra_sync<NW>();\n    uint32_t A[4]",
            "    intra_sync<NW>();\n    K4_TICK(2)\n    uint32_t A[4]")
    s = rep(s, "    const int16_t* rk = res[k & 1];\n",
            "    const int16_t* rk = res[k & 1];\n    K4_TICK(3)\n")
    s = rep(s, "left, r > 0, c > 0, rk, res_at, s_t, s_bm, lane, rows);\n",
            "left, r > 0, c > 0, rk, res_at, s_t, s_bm, lane, rows);\n"
            "    K4_TICK(4)\n")
    s = rep(s, "    if (rows) {\n      uint32_t u[4];",
            "    K4_TICK(5)\n    if (rows) {\n      uint32_t u[4];")
    return rep(s, "    if (tid == 0) row_publish(prog, cn);\n    c = cn;\n  }\n}",
               "    if (tid == 0) row_publish(prog, cn);\n    K4_TICK(6)\n"
               "    c = cn;\n  }\n  if (tid == 0) {\n"
               "    for (int k = 0; k < 7; ++k)\n"
               "      atomicAdd(&g_k4phase[k], (unsigned long long)ph_[k]);\n"
               "    atomicAdd(&g_k4phase[14], (unsigned long long)n_intra_);\n"
               "    atomicAdd(&g_k4phase[15], (unsigned long long)n_bpred_);\n"
               "  }\n}")


# the six-tap kernel's body with one thread per output pixel, both passes
# straight from the plane (sixtap_device.cuh's sixtap_pixel: per-index
# clamped byte loads, the taps from __constant__ at each thread's phase)
BYTE_BODY = """#include "sixtap_device.cuh"

#define MC_THREADS 256
#define MC_PER_MB 384

__global__ void __launch_bounds__(MC_THREADS) mc_planes_kernel(McArgs a) {
  const int R = a.R, C = a.C, g = blockIdx.y;
  const int t = blockIdx.x * MC_THREADS + threadIdx.x;
  if (t >= R * C * 384) return;
  const int m = t / 384, u = t - m * 384;
  const int r = m / C, c = m - r * C;
  const bool luma = u < 256;
  const int pl = luma ? 0 : 1 + ((u - 256) >> 6);
  const int k = luma ? u : (u - 256) & 63;
  const int S = luma ? 16 : 8, py = k / S, px = k % S;
  const int b = luma ? (py >> 2) * 4 + (px >> 2) : (py >> 2) * 2 + (px >> 2);
  const size_t mb = (size_t)g * R * C + m;
  const int slot = a.sel ? clampi(a.sel[mb] - 1, 0, 2) : 0;
  const uint8_t* ref = a.ref[0][0];
  long long bstride = a.bstride[0][0];
#pragma unroll
  for (int q = 1; q < 9; ++q)
    if (q == pl * 3 + slot) {
      ref = a.ref[q / 3][q % 3];
      bstride = a.bstride[q / 3][q % 3];
    }
  ref += g * bstride;
  const int* mv = luma ? a.mv[0] + mb * a.mv_mb[0] + b * a.mv_blk[0]
                       : a.mv[1] + mb * a.mv_mb[1] + b * a.mv_blk[1];
  uint8_t* out = pl == 0 ? a.out[0] : pl == 1 ? a.out[1] : a.out[2];
  out[mb * MC_TILES + py * S + px] = (uint8_t)sixtap_pixel(
      ref, R * S, C * S, r * S + py, c * S + px, mv[0], mv[1]);
}

"""


def mc_byte_per_thread(s):
    """The six-tap kernel computing one output byte a thread, each with its
    own two passes from the plane, as the parent's body did (without its
    staged windows)."""
    i, j = s.index("#define MC_THREADS 192"), s.index("// p: 28 words")
    s = s[:i] + BYTE_BODY + s[j:]
    return rep(s, "  const int threads = R * C * 24;",
               "  const int threads = R * C * MC_PER_MB;")


# the first form of the new body: a thread a 4-pixel row of a 4x4 block,
# the block's 4 lanes sharing its 9 filtered rows by shuffles
QUAD_BODY = """__device__ __forceinline__ uint32_t quad_v_pass(const uint32_t (&v)[6],
                                                int fy, const uint32_t* taps) {
  if (fy == 0) return v[2];
  const uint32_t ta = taps[2 * fy], tb = taps[2 * fy + 1];
  const uint32_t p01 = __byte_perm(v[0], v[1], 0x5140);
  const uint32_t p23 = __byte_perm(v[2], v[3], 0x5140);
  const uint32_t p45 = __byte_perm(v[4], v[5], 0x5140);
  const uint32_t q01 = __byte_perm(v[0], v[1], 0x7362);
  const uint32_t q23 = __byte_perm(v[2], v[3], 0x7362);
  const uint32_t q45 = __byte_perm(v[4], v[5], 0x7362);
  return pack4(tap6(__byte_perm(p01, p23, 0x5410), p45, ta, tb),
               tap6(__byte_perm(p01, p23, 0x7632), p45 >> 16, ta, tb),
               tap6(__byte_perm(q01, q23, 0x5410), q45, ta, tb),
               tap6(__byte_perm(q01, q23, 0x7632), q45 >> 16, ta, tb));
}

#define MC_THREADS 256
#define MC_PER_MB 96

__global__ void __launch_bounds__(MC_THREADS) mc_planes_kernel(McArgs a) {
  __shared__ uint32_t s_taps[16];
  if (threadIdx.x < 16) s_taps[threadIdx.x] = packed_taps(threadIdx.x);
  __syncthreads();
  const int R = a.R, C = a.C, g = blockIdx.y;
  const int t = blockIdx.x * MC_THREADS + threadIdx.x;
  if (t >= R * C * 96) return;
  const int m = t / 96, u = t - m * 96;
  const int r = m / C, c = m - r * C;
  const bool luma = u < 64;
  const int pl = luma ? 0 : 1 + ((u - 64) >> 4);
  const int b = luma ? u >> 2 : (u >> 2) & 3;
  const int i = u & 3;
  const int S = luma ? 16 : 8;
  const int by = (luma ? b >> 2 : b >> 1) * 4, bx = (luma ? b & 3 : b & 1) * 4;
  const size_t mb = (size_t)g * R * C + m;
  const int slot = a.sel ? clampi(a.sel[mb] - 1, 0, 2) : 0;
  const uint8_t* ref = a.ref[0][0];
  long long bstride = a.bstride[0][0];
#pragma unroll
  for (int q = 1; q < 9; ++q)
    if (q == pl * 3 + slot) {
      ref = a.ref[q / 3][q % 3];
      bstride = a.bstride[q / 3][q % 3];
    }
  ref += g * bstride;
  const int* mv = luma ? a.mv[0] + mb * a.mv_mb[0] + b * a.mv_blk[0]
                       : a.mv[1] + mb * a.mv_mb[1] + b * a.mv_blk[1];
  uint8_t* out = pl == 0 ? a.out[0] : pl == 1 ? a.out[1] : a.out[2];
  const int mvx = mv[0], mvy = mv[1];
  const int H = R * S, W = C * S;
  const int ys = r * S + by + (mvy >> 3) - 2;
  const int xs = c * S + bx + (mvx >> 3) - 2;
  const int fx = mvx & 7;
  const uint32_t h0 = h_row(ref, H, W, ys + i, xs, fx, s_taps);
  const uint32_t h1 = h_row(ref, H, W, ys + i + 4, xs, fx, s_taps);
  const uint32_t h2 = h_row(ref, H, W, ys + 8, xs, fx, s_taps);
  uint32_t v[6];
  const int quad = threadIdx.x & 28;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    if (k == 0) { v[0] = h0; continue; }
    if (k == 4) { v[4] = h1; continue; }
    const int j = ((i - k) & 3) + k;
    const uint32_t send = j < 4 ? h0 : j < 8 ? h1 : h2;
    v[k] = __shfl_sync(0xffffffffu, send, quad | ((i + k) & 3));
  }
  *reinterpret_cast<uint32_t*>(out + mb * MC_TILES + (by + i) * S + bx) =
      quad_v_pass(v, mvy & 7, s_taps);
}

"""


def mc_quad(s):
    """The six-tap kernel with a thread a 4-pixel row of a 4x4 block (96
    threads a macroblock), the block's 4 lanes computing 3 of its 9
    filtered rows each and sharing them by shuffles."""
    i, j = s.index("#define MC_THREADS 192"), s.index("// p: 28 words")
    s = s[:i] + QUAD_BODY + s[j:]
    return rep(s, "  const int threads = R * C * 24;",
               "  const int threads = R * C * MC_PER_MB;")


# variant: {file: edit}, built from SOURCES_K4
VARIANTS_K4 = {
    "kept": {},
    "k4_one_warp": {"wavefront.cu": k4_warps(1)},
    "k4_two_warps": {"wavefront.cu": k4_warps(2)},
    "k4_publish_every": {"wavefront_device.cuh": in_kernel(K4_HEAD,
                                                           k4_publish_every)},
    "k4_clocked": {"wavefront_device.cuh": lambda s: in_kernel(
        K4_HEAD, k4_clocked)(k4_clocked_globals(s))},
    "mc_byte_per_thread": {"sixtap_mc.cu": mc_byte_per_thread},
    "mc_quad": {"sixtap_mc.cu": mc_quad},
}
SOURCES_K4 = ("wavefront", "sixtap_mc")


def stacked(fn):
    """``fn`` (predict_mb_tiles) called as the parent's single-frame path
    called the six-tap kernel: the three references of each plane first
    stacked into one (1, 3, H, W) tensor, a device copy."""
    def wrapper(refs, ref_sel, sub_mv, uv_mv):
        return fn({p: torch.stack(list(r))[None] for p, r in refs.items()},
                  ref_sel, sub_mv, uv_mv)
    return wrapper


def k4_mc_cases():
    """[(wrapper, case, args)]: K4 on the single-frame decoder's 720p
    frames 1 and 0 and on 176x144; the six-tap kernel on the GOP path's
    720p G=16 frame 1, the single-frame path's frame 1 (G=1, the rasters
    unstacked; and stacked, the parent's copy), the fast path's pair."""
    ivf = cs.IVFReader(cs.CLIP)
    payloads = [ivf.frame(i) for i in (0, 1)]
    small = cs.IVFReader(cs.SMALL_CLIP)
    sf = cs.single_frame_kernel_inputs(payloads, ivf.width, ivf.height)
    sfs = cs.single_frame_kernel_inputs([small.frame(0), small.frame(1)],
                                        small.width, small.height)
    out = [(intra_cuda.intra_frame, "k4_720p_inter", sf[("intra_frame", 1)][0]),
           (intra_cuda.intra_frame, "k4_720p_key", sf[("intra_frame", 0)][0]),
           (intra_cuda.intra_frame, "k4_176x144_inter",
            sfs[("intra_frame", 1)][0]),
           (intra_cuda.intra_frame, "k4_176x144_key",
            sfs[("intra_frame", 0)][0])]
    kept = cs.real_kernel_inputs(payloads, ivf.width, ivf.height, cs.G)
    big = cs.decoded_frames(cs.CLIP, (0, 1))
    fast = cs.fast_kernel_inputs(big[0], big[1], cs.FAST_PAIR_KEY_QI,
                                 cs.FAST_PAIR_QIS)[2]
    mc1 = sf[("predict_mb_tiles", 1)][0]
    out += [(sixtap_cuda.mc_tiles, "mc_720p_G16", kept["mc"]),
            (sixtap_cuda.predict_mb_tiles, "mc_720p_G1", mc1),
            (stacked(sixtap_cuda.predict_mb_tiles), "mc_720p_G1_stacked",
             mc1),
            (sixtap_cuda.predict_mb_tiles, "mc_720p_fast_pair", fast)]
    return out


def run_k4_mc(card, parts):
    """Time K4 (``parts`` holds "k4") and the six-tap kernel ("mc") with
    each step of their redesign undone (VARIANTS_K4), "kept" first and
    last, and K4's clocked phases."""
    variants = {n: e for n, e in VARIANTS_K4.items()
                if n == "kept" or n.split("_")[0] in parts}
    write_variants(variants)
    t0 = time.perf_counter()
    logs = build([(os.path.join(OUT, n, "lib%s.so" % src),
                   os.path.join(OUT, n, src + ".cu"))
                  for n in variants for src in SOURCES_K4])
    cs.say("ablation_build", seconds=time.perf_counter() - t0,
           ptxas={os.path.relpath(k, OUT): v for k, v in logs.items()})
    cases = [c for c in k4_mc_cases() if c[1].split("_")[0] in parts]
    saved = intra_cuda._entry, sixtap_cuda._entry
    ref, ok = {}, True
    try:
        for name in list(variants) + ["kept"]:
            d = os.path.join(OUT, name)
            intra_cuda._entry = lambda d=d: lib_entry(
                os.path.join(d, "libwavefront.so"), "intra_frame_launch",
                intra_cuda.ARGTYPES)
            sixtap_cuda._entry = lambda d=d: lib_entry(
                os.path.join(d, "libsixtap_mc.so"), "mc_planes_launch",
                sixtap_cuda.ARGTYPES)
            ms, equal = {}, {}
            for fn, case, a in cases:
                key = case.replace("_stacked", "")
                out = fn(*a)
                ref.setdefault(key, out)
                equal[case] = all(torch.equal(x, y)
                                  for x, y in zip(out, ref[key]))
                ms[case] = cs.time_ms(lambda: fn(*a), 20)
            ok &= all(equal.values())
            cs.say("ablation", variant=name, card=card, ms=ms, equal=equal)
            if name == "k4_clocked":
                lib = ctypes.CDLL(os.path.join(d, "libwavefront.so"))
                buf = (ctypes.c_ulonglong * 16)()
                for fn, case, a in [c for c in cases
                                    if c[1].startswith("k4_720p")]:
                    lib.k4_phase_zero()
                    fn(*a)
                    torch.cuda.synchronize()
                    lib.k4_phase_read(buf)
                    n, n_intra, n_bpred = a[6].numel(), buf[14], buf[15]
                    per = [n] + [max(n_intra, 1)] * 4 + [max(n_bpred, 1)] \
                        + [max(n_intra, 1)]
                    cs.say("ablation_k4_phases", case=case, card=card,
                           macroblocks=n, intra=n_intra, b_pred=n_bpred,
                           cycles_per_macroblock={
                               p: buf[i] / per[i]
                               for i, p in enumerate(K4_PHASES)})
    finally:
        intra_cuda._entry, sixtap_cuda._entry = saved
    return ok


def k7_variant_entry(lib_path, persistent):
    """The C entry of a K7 library typed as enc_intra_cuda types it; a
    library of the diagonal form (the parent's: no schedule arguments) is
    called through a shim that drops them."""
    f = getattr(ctypes.CDLL(lib_path), "encode_kf_frame_launch")
    f.restype = ctypes.c_int
    types = enc_intra_cuda.ARGTYPES[:None if persistent else -2]
    f.argtypes = list(types) + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    if persistent:
        return f
    n = len(types)
    return lambda *a: f(*(a[:n] + a[-2:]))


def k7_clocked(card, csrc, tag):
    """Thread 0's cycles a macroblock per phase of K7 built from ``csrc``
    (a csrc/ directory), one-pass and two-pass at 720p."""
    d = os.path.join(OUT, "k7_clocked_" + tag)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(csrc, d)
    for fn, edit in (("enc_intra.cu", clocked_k7),
                     ("enc_mb_device.cuh", clocked_k7_steps)):
        p = os.path.join(d, fn)
        with open(p) as fh:
            text = edit(fh.read())
        with open(p, "w") as fh:
            fh.write(text)
    so = os.path.join(d, "libenc_intra.so")
    cs.say("ablation_build", variant="k7_clocked_" + tag,
           ptxas=build([(so, os.path.join(d, "enc_intra.cu"))])[so])
    with open(os.path.join(d, "enc_intra.cu")) as fh:
        persistent = "row_wait(" in fh.read()
    f = k7_variant_entry(so, persistent)
    lib = ctypes.CDLL(so)
    saved = enc_intra_cuda._entry
    enc_intra_cuda._entry = lambda: f
    buf = (ctypes.c_ulonglong * 16)()
    try:
        for case, args in k7_cases().items():
            lib.k7_phase_zero()
            enc_intra_cuda.encode_kf_frame(*args)
            torch.cuda.synchronize()
            lib.k7_phase_read(buf)
            n = args[0].numel() // 256
            cs.say("ablation_k7_phases", source=tag, case=case, card=card,
                   cycles_per_macroblock={p: buf[i] / n
                                          for i, p in enumerate(K7_PHASES)})
    finally:
        enc_intra_cuda._entry = saved


_K7_CASES = {}


def run_k7_k5(card):
    """Time K7, K8 rt and K5 with each step of K7's and K5's redesign
    undone (VARIANTS_K7)."""
    write_variants(VARIANTS_K7)
    t0 = time.perf_counter()
    logs = build([(os.path.join(OUT, n, "lib%s.so" % src),
                   os.path.join(OUT, n, src + ".cu"))
                  for n in VARIANTS_K7 for src in SOURCES_K7])
    cs.say("ablation_build", seconds=time.perf_counter() - t0,
           ptxas={os.path.relpath(k, OUT): v for k, v in logs.items()})
    big = cs.decoded_frames(cs.CLIP, (0, 1))
    ivf = cs.IVFReader(cs.CLIP)
    sf = cs.single_frame_kernel_inputs([ivf.frame(i) for i in (0, 1)],
                                       ivf.width, ivf.height)
    cases = [(enc_intra_cuda.encode_kf_frame, "k7_" + k, a)
             for k, a in k7_cases().items()]
    cases += [(enc_inter_cuda.encode_inter_frame, "k8_rt",
               cs.k8_args(big[0], big[1], 48, [48], "rt")),
              (lf_cuda.loop_filter, "k5_frame1", sf[("loop_filter", 1)][0]),
              (lf_cuda.loop_filter, "k5_search",
               cs.k5_search_inputs(big[0], 24))]
    ref, ok = {}, True
    for name in list(VARIANTS_K7) + ["kept"]:
        enc_intra_cuda._entry = lambda n=name: entry(n, "enc_intra")
        lf_cuda._entry = lambda n=name: entry(n, "wavefront")
        enc_inter_cuda._entry = lambda n=name: entry(n, "enc_inter")
        ms, equal = {}, {}
        for fn, case, a in cases:
            out = fn(*a)
            ref.setdefault(case, out)
            equal[case] = all(torch.equal(x, y)
                              for x, y in zip(out, ref[case]))
            ms[case] = cs.time_ms(lambda: fn(*a), 10)
        ok &= all(equal.values())
        cs.say("ablation", variant=name, card=card, ms=ms, equal=equal)
    return ok


def k7_cases():
    """K7's 720p cases: frame 0 one-pass at qi 24, two-pass at qi 32 under
    the default token costs."""
    if not _K7_CASES:
        big = cs.decoded_frames(cs.CLIP, (0,))
        tc = torch.from_numpy(cs.token_costs_pm(
            cs.T.DEFAULT_COEFF_PROBS)).to(cs.DEV)
        _K7_CASES.update({"one_pass": cs.kf_args(big[0], 24),
                          "two_pass": cs.kf_args(big[0], 32, tc)})
    return _K7_CASES


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_ablation.py needs a CUDA device")
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="a checkout of the parent commit")
    ap.add_argument("--kernels", default="k4,mc,sass,pairs",
                    help="comma-separated: k4 (K4's variants and clocked "
                         "phases), mc (the six-tap kernel's variants), k1 "
                         "(K1's and K10's variants), k7 (K7's clocked "
                         "phases), k5 (K7's and K5's variants), k8 (K8's "
                         "and K9's, with --parent also the machine code), "
                         "sass (the machine code alone, with --parent), "
                         "pairs (with --parent: K4, the six-tap kernel and "
                         "K1 timed from the parent's library and this one's "
                         "in alternation), spans (with --parent: "
                         "enc.fast_kernel and decode.reconstruct in the "
                         "parent's tree and this one's, four processes), "
                         "rebase (with --parent: the residue update and "
                         "rebased frames/s, likewise), k1_all_modes (K1's "
                         "and K4's B_PRED step predicting all ten b-modes, "
                         "under the memory check)")
    ap.add_argument("--pairs", type=int, default=12,
                    help="readings of each side in the pairs")
    args = ap.parse_args()
    kernels = set(args.kernels.split(","))
    card = cs.smi()
    cs.say("ablation_env", card=card, device=torch.cuda.get_device_name(0))
    os.makedirs(OUT, exist_ok=True)
    ok = True
    if kernels & {"k4", "mc"}:
        ok &= run_k4_mc(card, kernels & {"k4", "mc"})
    if "k1" in kernels:
        ok &= run_k1_k10(card)
    if "k1_all_modes" in kernels:
        ok &= run_k1_all_modes(card)
    if "k7" in kernels:
        k7_clocked(card, _build.CSRC_DIR, "here")
        if args.parent:
            k7_clocked(card, os.path.join(args.parent, "alfalfa_tpu_torch",
                                          "csrc"), "parent")
    if "k5" in kernels:
        ok &= run_k7_k5(card)
    if "k8" in kernels:
        ok &= run_k8_k9(card, args.parent)
    if "sass" in kernels and "k8" not in kernels and args.parent:
        sass(args.parent)
    if "pairs" in kernels and args.parent:
        ok &= parent_pairs(card, args.parent, args.pairs)
    if "spans" in kernels and args.parent:
        run_spans(card, os.path.abspath(args.parent))
    if "rebase" in kernels:
        ok &= run_rebase_variants(card)
        if args.parent:
            run_rebase(card, os.path.abspath(args.parent))
    if not ok:
        raise SystemExit("a variant's output differs from the kept form's "
                         "(or, in the pairs, from the parent's)")


def sass(parent):
    cs.say("ablation_sass", **{k: {"instructions_parent": a,
                                   "instructions_here": b,
                                   "identical": same,
                                   "differing_beyond_constant_offsets": n}
                               for k, (a, b, same, n) in
                               same_sass(parent).items()})


def run_k8_k9(card, parent):
    """Time K8 and K9 with each step of their redesign undone (VARIANTS),
    K8's clocked phases; with ``parent``, compare SAME_SASS's machine
    code."""
    write_variants(VARIANTS)
    t0 = time.perf_counter()
    logs = build([(os.path.join(OUT, n, "lib%s.so" % src),
                   os.path.join(OUT, n, src + ".cu"))
                  for n in VARIANTS for src in SOURCES])
    cs.say("ablation_build", seconds=time.perf_counter() - t0,
           ptxas={os.path.relpath(k, OUT): v for k, v in logs.items()})
    if parent:
        sass(parent)

    big = cs.decoded_frames(cs.CLIP, (0, 1))
    k8 = {"best": cs.k8_args(big[0], big[1], 48, [48]),
          "rt": cs.k8_args(big[0], big[1], 48, [48], "rt"),
          "pair": cs.k8_args(big[0], big[1], cs.INTER_PAIR_KEY_QI,
                             cs.INTER_PAIR_QIS, "rt"),
          "extreme": cs.k8_extreme(44)}
    k9 = {"k9": cs.fast_kernel_inputs(big[0], big[1], 48, [cs.FAST_QI])[0],
          "k9_pair": cs.fast_kernel_inputs(big[0], big[1],
                                           cs.FAST_PAIR_KEY_QI,
                                           cs.FAST_PAIR_QIS)[0]}
    ref, ok = {}, True
    for name in list(VARIANTS) + ["kept"]:
        enc_inter_cuda._entry = lambda n=name: entry(n, "enc_inter")
        enc_decide_cuda._entry = lambda n=name: entry(n, "enc_decide")
        ms, equal = {}, {}
        for case, a in k8.items():
            out = enc_inter_cuda.encode_inter_frame(*a)
            ref.setdefault(case, out)
            equal[case] = all(torch.equal(x, y)
                              for x, y in zip(out, ref[case]))
            ms[case] = cs.time_ms(lambda: enc_inter_cuda.encode_inter_frame(*a),
                                  10)
        for case, a in k9.items():
            out = enc_decide_cuda.decide_inter_frame(*a)
            ref.setdefault(case, out)
            equal[case] = torch.equal(out, ref[case])
            ms[case] = cs.time_ms(lambda: enc_decide_cuda.decide_inter_frame(*a),
                                  10)
        ok &= all(equal.values())
        cs.say("ablation", variant=name, card=card, ms=ms, equal=equal)
        if name == "clocked":
            lib = ctypes.CDLL(os.path.join(OUT, name, "libenc_inter.so"))
            buf = (ctypes.c_ulonglong * 8)()
            for case in ("best", "rt", "pair"):
                lib.phase_zero()
                enc_inter_cuda.encode_inter_frame(*k8[case])
                torch.cuda.synchronize()
                lib.phase_read(buf)
                n = k8[case][0].numel() // 256 * k8[case][6].shape[0]
                cs.say("ablation_phases", case=case, card=card,
                       cycles_per_macroblock={p: buf[i] / n
                                              for i, p in enumerate(PHASES)})
    return ok


# ---- the spans ISSUE-level predictions name, this tree against the parent

# run as ``python -c SPANS_CHILD TREE`` from TREE's root: TREE's own
# package times enc.fast_kernel (the fast path's device function, a fast
# rt interframe at 720p, traced) and decode.reconstruct (the single-frame
# decoder, a 720p frame, traced), three passes after a warm-up; one JSON
# line
SPANS_CHILD = r"""
import json, os, sys, time
root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
os.chdir(root)
import torch
import chip_smoke as cs
from alfalfa_tpu_torch import _build
from alfalfa_tpu_torch.decoder import Decoder
from alfalfa_tpu_torch.encoder import Encoder
from alfalfa_tpu_torch.util import tracing

_build.build_all()
ivf = cs.IVFReader(cs.CLIP)
payloads = [ivf.frame(i) for i in range(len(ivf))]
frames = {k: r.display() for k, r in
          cs.decoded_frames(cs.CLIP, tuple(range(6))).items()}
out = {"tree": sys.argv[1], "fast_kernel_ms": [], "fast_host_ms": [],
       "reconstruct_ms": []}
for rep in range(4):
    e = Encoder(ivf.width, ivf.height, quality="rt", fast=True, device=cs.DEV)
    e.encode_with_quantizer(frames[0], cs.FAST_QI, key_frame=True)
    tracing.enable(rep > 0)
    tracing.snapshot()
    for k in cs.FAST_ORDER:
        e.encode_with_quantizer(frames[k], cs.FAST_QI)
    torch.cuda.synchronize()
    spans = tracing.snapshot()
    d = Decoder(ivf.width, ivf.height, device=cs.DEV)
    for p in payloads:
        d.decode_frame(p)
    torch.cuda.synchronize()
    dspans = tracing.snapshot()
    tracing.enable(False)
    if rep:
        n = len(cs.FAST_ORDER)
        out["fast_kernel_ms"].append(spans["enc.fast_kernel"]["seconds"] * 1e3 / n)
        out["fast_host_ms"].append(spans["enc.fast_host"]["seconds"] * 1e3 / n)
        out["reconstruct_ms"].append(
            dspans["decode.reconstruct"]["seconds"] * 1e3 / len(payloads))
print(json.dumps(out), flush=True)
"""


def run_spans(card, parent):
    """SPANS_CHILD in the parent's tree and this one's, in the order
    parent, this, this, parent (each a fresh process): the spans' readings
    and their medians per tree."""
    got = {"parent": [], "here": []}
    for tag, tree in (("parent", parent), ("here", REPO), ("here", REPO),
                      ("parent", parent)):
        res = subprocess.run([sys.executable, "-c", SPANS_CHILD, tree],
                             capture_output=True, text=True, check=True)
        got[tag].append(json.loads(res.stdout.strip().splitlines()[-1]))
    line = {}
    for tag, runs in got.items():
        for k in ("fast_kernel_ms", "fast_host_ms", "reconstruct_ms"):
            vals = [v for r in runs for v in r[k]]
            line["%s_%s" % (tag, k)] = vals
            line["%s_%s_median" % (tag, k)] = statistics.median(vals)
    cs.say("ablation_spans", card=card, **line)


# ---- the residue kernel: each step of its design undone

def rebase_rows_only(s):
    """The frame's inter macroblocks on the R row walkers alone: one block
    a row, as before the pair tickets spread them over the card."""
    return rep(s, "rebase_row_kernel<<<R > blocks ? R : blocks, 256, 0,",
               "rebase_row_kernel<<<R, 256, 0,")


def rebase_two_blocks(s):
    """Two blocks an SM: the registers held to 128 a thread, twice the
    blocks launched."""
    s = rep(s, "__launch_bounds__(256) rebase_row_kernel(",
            "__launch_bounds__(256, 2) rebase_row_kernel(")
    return rep(s, "rebase_row_kernel<<<R > blocks ? R : blocks, 256, 0,",
               "rebase_row_kernel<<<R > 2 * blocks ? R : 2 * blocks, 256, 0,")


VARIANTS_REBASE = {"rows_only": {"rebase_residues.cu": rebase_rows_only},
                   "two_blocks": {"rebase_residues.cu": rebase_two_blocks}}


def rebase_cases():
    """[(case, args)]: the residue kernel on 720p rebased frames 4 and 5's
    arguments, captured from chip_smoke's rebase, on every macroblock
    inter and on every one intra."""
    ivf = cs.IVFReader(cs.CLIP)
    frames = cs.decoded_frames(cs.CLIP, tuple(range(cs.REBASE_FRAMES)))
    frames = [frames[k].display() for k in range(cs.REBASE_FRAMES)]
    out = [("720p rebased frame %d" % (cs.REBASE_CHUNK + 1 + i), a)
           for i, a in enumerate(cs.rebase_kernel_inputs(frames, ivf.width,
                                                         ivf.height))]
    return out + [("720p all inter", cs.rebase_synthetic(
        54, 1280, 720, 48, "whole")), ("720p all intra", cs.rebase_synthetic(
            55, 1280, 720, 48, "intra"))]


def run_rebase_variants(card):
    """Time the residue kernel kept, rows_only, two_blocks and lag_two,
    kept first and last, each output held to the first's."""
    write_variants(VARIANTS_REBASE)
    t0 = time.perf_counter()
    logs = build([(os.path.join(OUT, n, "librebase_residues.so"),
                   os.path.join(OUT, n, "rebase_residues.cu"))
                  for n in VARIANTS_REBASE])
    cs.say("ablation_build", seconds=time.perf_counter() - t0,
           ptxas={os.path.relpath(k, OUT): v for k, v in logs.items()})
    cases = rebase_cases()
    libs = {n: lib_entry(os.path.join(OUT, n, "librebase_residues.so"),
                         "rebase_frame_launch", rebase_cuda.ARGTYPES)
            for n in VARIANTS_REBASE}
    saved = rebase_cuda._entry, rebase_cuda.ROW_LAG_WHOLE
    ref, ok = {}, True
    try:
        for name in ("kept", "rows_only", "two_blocks", "lag_two", "kept"):
            rebase_cuda._entry = saved[0] if name not in libs \
                else (lambda f=libs[name]: f)
            rebase_cuda.ROW_LAG_WHOLE = 2 if name == "lag_two" else saved[1]
            ms, equal = {}, {}
            for case, (orig, refs, words, quant, recon) in cases:
                out = cs.residue_call(rebase_cuda.rebase_frame)(
                    orig, refs, words, quant, recon)
                ref.setdefault(case, out)
                equal[case] = all(torch.equal(x, y)
                                  for x, y in zip(out, ref[case]))
                planes = [p.clone() for p in recon]
                ms[case] = cs.time_ms(lambda: rebase_cuda.rebase_frame(
                    orig, refs, words, quant, planes), 20)
            ok &= all(equal.values())
            cs.say("ablation", variant=name, card=card, ms=ms, equal=equal)
    finally:
        rebase_cuda._entry, rebase_cuda.ROW_LAG_WHOLE = saved
    return ok


# run as ``python -c REBASE_CHILD TREE`` from TREE's root: TREE's own
# package rebases frames 3-5 of the 720p clip onto chunk 0 as chip_smoke's
# rebase phase does (its rebase_setup and rebase_run): a warm-up, five
# passes for rebased frames/s, then three traced passes with every
# update_residues call timed (the device drained at both ends) and the
# residue update's own spans summed (rebase.inputs, .kernel, .fetch and,
# where it exists, .intra_host; not the token counts and probabilities
# both trees compute alike); one JSON line
REBASE_CHILD = r"""
import json, os, sys, time
root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
os.chdir(root)
import torch
import chip_smoke as cs
from alfalfa_tpu_torch import _build
from alfalfa_tpu_torch.decoder import Decoder
from alfalfa_tpu_torch.encoder import reencode as RB
from alfalfa_tpu_torch.util import tracing

_build.build_all()
ivf = cs.IVFReader(cs.CLIP)
W, H = ivf.width, ivf.height
frames = cs.decoded_frames(cs.CLIP, tuple(range(cs.REBASE_FRAMES)))
frames = [frames[k].display() for k in range(cs.REBASE_FRAMES)]
state, payloads = cs.rebase_setup(frames, W, H)
pred = RB.parse_prediction(payloads, Decoder(W, H, device=cs.DEV))
n = cs.REBASE_FRAMES - cs.REBASE_CHUNK
cs.rebase_run(frames, W, H, state, pred)
fps = [n / cs.rebase_run(frames, W, H, state, pred)[1] for _ in range(5)]
real, whole, own = RB.update_residues, [], []

def timed(*a):
    t0 = cs.sync_clock()
    out = real(*a)
    whole.append((cs.sync_clock() - t0) * 1e3)
    return out

RB.update_residues = timed
tracing.enable(True)
for _ in range(3):
    tracing.snapshot()
    cs.rebase_run(frames, W, H, state, pred)
    spans = tracing.snapshot()
    own.append(sum(spans[k]["seconds"] for k in (
        "rebase.inputs", "rebase.kernel", "rebase.fetch", "rebase.intra_host")
        if k in spans) * 1e3 / (n - 1))
tracing.enable(False)
print(json.dumps({"tree": sys.argv[1], "rebased_frames_per_s": fps,
                  "update_residues_ms": whole, "residue_update_ms": own,
                  "spans_ms_per_residue_frame": {
                      k: v["seconds"] * 1e3 / (n - 1) for k, v in spans.items()
                      if k.startswith("rebase.")}}), flush=True)
"""


def run_rebase(card, parent):
    """REBASE_CHILD in the parent's tree and this one's, in the order
    parent, this, this, parent (each a fresh process): the readings and
    their medians per tree."""
    got = {"parent": [], "here": []}
    for tag, tree in (("parent", parent), ("here", REPO), ("here", REPO),
                      ("parent", parent)):
        res = subprocess.run([sys.executable, "-c", REBASE_CHILD, tree],
                             capture_output=True, text=True, check=True)
        got[tag].append(json.loads(res.stdout.strip().splitlines()[-1]))
    line = {}
    for tag, runs in got.items():
        for k in ("residue_update_ms", "update_residues_ms",
                  "rebased_frames_per_s"):
            vals = [v for r in runs for v in r[k]]
            line["%s_%s" % (tag, k)] = vals
            line["%s_%s_median" % (tag, k)] = statistics.median(vals)
        line["%s_spans" % tag] = [r["spans_ms_per_residue_frame"]
                                  for r in runs]
    cs.say("ablation_rebase", card=card, **line)


# ---- the kernels this redesign holds to the parent: each case timed from
# the parent's library and from this checkout's in alternation

# C entry: (the argument types this checkout's wrapper gives it, the
# wrapper's module)
PAIR_ENTRIES = {
    "intra_frame_launch": (intra_cuda.ARGTYPES, intra_cuda),
    "mc_planes_launch": (sixtap_cuda.ARGTYPES, sixtap_cuda),
    "wavefront_decode_launch": (wavefront_cuda.ARGTYPES, wavefront_cuda),
}


def parent_launch(entry, name, device, *args):
    """The parent's _build.launch: the device switched and the stream read
    through torch.cuda on every call."""
    issued = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = entry(*args, torch.cuda.current_stream().cuda_stream,
                   ctypes.byref(issued))
    if rc != 0:
        raise RuntimeError("%s launch failed: CUDA error %d" % (name, rc))
    return issued.value


def parent_k4(entry):
    """K4's wrapper as the parent had it, around the parent's ``entry``
    (planes out, tiles, residuals, words, bmode; G, R, C): one untile
    launch and one launch per diagonal."""
    def wrapper(y, u, v, res_y, res_u, res_v, ymode, uvmode, bmode,
                has_nonzero, intra_mask):
        G, R, C = ymode.shape
        dev = y.device
        wavefront_cuda.check_wave_inputs(
            dev, G, R, C, y, u, v, res_y, res_u, res_v, bmode,
            {"ymode": ymode, "uvmode": uvmode, "has_nonzero": has_nonzero,
             "intra_mask": intra_mask})
        mbp = wavefront_cuda.pack_mb_params(ymode, uvmode, has_nonzero,
                                            intra_mask)
        Y, U, V = wavefront_cuda.empty_planes(G, R, C, dev)
        parent_launch(entry, "parent intra_frame", dev,
                      *(t.data_ptr() for t in (Y, U, V, y, u, v, res_y,
                                               res_u, res_v, mbp, bmode)),
                      G, R, C)
        return Y, U, V
    return wrapper


def parent_plane(entry, refs, ref_sel, sub_mv, S, slots=3):
    """One per-plane call of the parent's six-tap kernel, with the parent's
    wrapper's checks, output and launch: (G, R, C, S, S) uint8."""
    G, R, C = ref_sel.shape
    n, dev = S // 4, refs.device
    _build.check_tensor("refs", refs, torch.uint8, (G, slots, R * S, C * S),
                        dev)
    _build.check_tensor("ref_sel", ref_sel, torch.int32, (G, R, C), dev)
    _build.check_tensor("sub_mv", sub_mv, torch.int32, (G, R, C, n, n, 2),
                        dev)
    out = torch.empty((G, R, C, S, S), dtype=torch.uint8, device=dev)
    parent_launch(entry, "parent sixtap_mc", dev, refs.data_ptr(),
                  ref_sel.data_ptr(), sub_mv.data_ptr(), out.data_ptr(), G,
                  R, C, R * S, C * S, S)
    return out


def parent_mc(entry):
    """The parent's three per-plane calls (mc_tiles, or predict_mb_tiles
    at G=1) on the (G, 3, H, W) stacks its callers built: the planes'
    predictions.  ``wrapper.planes(args)`` gives the three calls apart,
    for the pairs' second reading: the three timed one by one and
    summed."""
    def one(p, args):
        refs, ref_sel, sub_mv, uv_mv = args
        mv, S = (sub_mv, 16) if p == "y" else (uv_mv, 8)
        return parent_plane(entry, refs[p], ref_sel, mv, S)

    def wrapper(*args):
        return tuple(one(p, args) for p in "yuv")
    wrapper.planes = lambda args: [lambda p=p: one(p, args) for p in "yuv"]
    return wrapper


def parent_fast_mc(entry):
    """The parent fast path's motion compensation (encode_inter_fast._mc):
    per plane and quantizer, the macroblocks' vectors expanded into a
    contiguous copy and the kernel launched on LAST alone."""
    def wrapper(planes, mvx, mvy, cmx, cmy):
        Q, R, C = mvx.shape
        out = []
        for plane, x, y, S in ((planes[0], mvx, mvy, 16),
                               (planes[1], cmx, cmy, 8),
                               (planes[2], cmx, cmy, 8)):
            per_q = []
            for q in range(Q):
                mv = torch.stack([x[q], y[q]], -1)[:, :, None, None, :] \
                    .expand(R, C, S // 4, S // 4, 2).to(torch.int32) \
                    .contiguous()
                sel = torch.zeros((R, C), dtype=torch.int32, device=mv.device)
                per_q.append(parent_plane(entry, plane[None, None], sel[None],
                                          mv[None], S, slots=1)[0])
            out.append(torch.stack(per_q))
        return tuple(out)
    return wrapper


# the parent's C entry, its argument types and wrapper, for the entries
# whose arguments this checkout changed
PARENT_WRAPPERS = {
    "intra_frame_launch": ("intra_frame_launch", [_PTR] * 11 + [_INT] * 3,
                           parent_k4),
    "mc_planes_launch": ("sixtap_mc_launch", [_PTR] * 4 + [_INT] * 6,
                         parent_mc),
    "mc_planes_launch fast": ("sixtap_mc_launch", [_PTR] * 4 + [_INT] * 6,
                              parent_fast_mc),
}


def parent_stacks(refs, ref_sel, sub_mv, uv_mv):
    """predict_mb_tiles' arguments in the parent's form: each plane's
    references stacked (G, 3, H, W), a selector map, contiguous vectors;
    made once, outside the timing (the parent's callers made them)."""
    G, R, C = sub_mv.shape[:3]
    st = {}
    for p, r in refs.items():
        if not torch.is_tensor(r):
            r = list(r) + [r[-1]] * (3 - len(r))
            r = torch.stack([t.expand((G,) + t.shape[-2:]) for t in r], 1)
        st[p] = r.contiguous()
    if ref_sel is None:
        ref_sel = torch.ones((G, R, C), dtype=torch.int32, device=cs.DEV)
    return st, ref_sel, sub_mv.contiguous(), uv_mv.contiguous()


def pair_cases():
    """[(source, C entry, case, wrapper, args, the parent's wrapper key and
    args)]: K4 on the single-frame decoder's 720p and 176x144 frames, the
    six-tap kernel on the GOP path's, the single-frame path's and the fast
    path's 720p calls (against the parent's three per-plane calls), K1 on
    the GOP decoder's 720p frames."""
    out = []
    cases = k4_mc_cases()
    for fn, case, args in cases:
        if case.startswith("k4"):
            out.append(("wavefront", "intra_frame_launch", case, fn, args,
                        ("intra_frame_launch", args)))
        elif case == "mc_720p_fast_pair":
            refs, _, sub_mv, uv_mv = args
            planes = tuple(refs[p][0] for p in "yuv")
            out.append(("sixtap_mc", "mc_planes_launch", case, fn, args,
                        ("mc_planes_launch fast",
                         (planes, sub_mv[..., 0, 0, 0], sub_mv[..., 0, 0, 1],
                          uv_mv[..., 0, 0, 0], uv_mv[..., 0, 0, 1]))))
        elif not case.endswith("_stacked"):
            out.append(("sixtap_mc", "mc_planes_launch", case, fn, args,
                        ("mc_planes_launch", parent_stacks(*args))))
    ivf = cs.IVFReader(cs.CLIP)
    kept = cs.real_kernel_inputs([ivf.frame(i) for i in (0, 1)], ivf.width,
                                 ivf.height, cs.G)
    for key, label in (("wave_inter", "interframe"), ("wave_key", "key frame")):
        out.append(("wavefront", "wavefront_decode_launch",
                    "k1 720p G=16 " + label, wavefront_cuda.wavefront_decode,
                    kept[key], (None, kept[key])))
    return out


def parent_pairs(card, parent, pairs):
    """Each pair_cases() case timed ``pairs`` times from the parent's
    library and from this checkout's, alternating which goes first, each
    reading the median of 10 calls: the medians of each side's readings,
    their spread, and whether the two outputs are equal."""
    jobs = [(os.path.join(OUT, "pairs", tag, "lib%s.so" % src),
             os.path.join(d, src + ".cu"))
            for src in ("wavefront", "sixtap_mc")
            for tag, d in (("parent", os.path.join(
                parent, "alfalfa_tpu_torch", "csrc")),
                ("here", _build.CSRC_DIR))]
    for so, _ in jobs:
        os.makedirs(os.path.dirname(so), exist_ok=True)
    cs.say("ablation_build", variant="pairs", ptxas={
        os.path.relpath(k, OUT): v for k, v in build(jobs).items()})

    def typed(tag, src, fn, types):
        return lib_entry(os.path.join(OUT, "pairs", tag, "lib%s.so" % src),
                         fn, types)

    ok = True
    for src, fn, case, wrapper, args, (pkey, pargs) in pair_cases():
        types, mod = PAIR_ENTRIES[fn]
        here = typed("here", src, fn, types)
        calls = {"here": (wrapper, args)}
        if pkey is not None:
            pfn, ptypes, make = PARENT_WRAPPERS[pkey]
            calls["parent"] = (make(typed("parent", src, pfn, ptypes)),
                               pargs)
            parent = here
        else:
            calls["parent"] = (wrapper, args)
            parent = typed("parent", src, fn, types)
        entries = {"here": here, "parent": parent}
        saved = mod._entry
        outs, ms = {}, {"parent": [], "here": []}
        planes = getattr(calls["parent"][0], "planes", None)
        if planes is not None:
            ms["parent_summed"] = []
        try:
            for i in range(pairs):
                for tag in (("parent", "here") if i % 2 == 0
                            else ("here", "parent")):
                    mod._entry = lambda t=tag: entries[t]
                    call, a = calls[tag]
                    if tag not in outs:
                        outs[tag] = call(*a)
                    ms[tag].append(cs.time_ms(lambda: call(*a), 10))
                    if tag == "parent" and planes is not None:
                        ms["parent_summed"].append(sum(
                            cs.time_ms(f, 10) for f in planes(a)))
        finally:
            mod._entry = saved
        tup = lambda x: x if isinstance(x, tuple) else (x,)
        equal = all(torch.equal(x, y) for x, y in
                    zip(tup(outs["parent"]), tup(outs["here"])))
        ok &= equal
        med = {t: statistics.median(v) for t, v in ms.items()}
        extra = {}
        if planes is not None:
            # the parent's three per-plane calls each timed alone and
            # summed, as its per-call times were recorded
            extra = dict(median_parent_summed=med["parent_summed"],
                         ratio_summed=med["here"] / med["parent_summed"],
                         range_parent_summed=[min(ms["parent_summed"]),
                                              max(ms["parent_summed"])])
        cs.say("ablation_pairs", case=case, card=card, pairs=pairs,
               equal=equal, median_parent=med["parent"],
               median_here=med["here"], ratio=med["here"] / med["parent"],
               range_parent=[min(ms["parent"]), max(ms["parent"])],
               range_here=[min(ms["here"]), max(ms["here"])], **extra)
    return ok


if __name__ == "__main__":
    main()
