#!/usr/bin/env python3
"""Ablation of the persistent kernels' steps on one NVIDIA GPU.

    python3 chip_ablation.py                  # from the repo root
    python3 chip_ablation.py --parent DIR     # also: K7's clocked phases on
                                              # DIR's sources, the machine
                                              # code of K4, K5, K7, K8 and
                                              # K9 against DIR's, and K10,
                                              # K4, K5, K1 and K8 timed against
                                              # DIR's in alternation
    python3 chip_ablation.py --kernels k1,sass,pairs --parent DIR
                                              # K1's and K10's steps undone,
                                              # the machine code, the pairs
    python3 chip_ablation.py --kernels k7     # K7's clocked phases only

Writes variants of alfalfa_tpu_torch/csrc/ into build/ablation/<variant>/,
each the sources with one step of a redesign undone (or, for "separable",
one tried step added), builds them all at once (one nvcc per source) and
times them on 720p inputs chip_smoke.py makes, every variant in one
process, "kept" first and last for the spread; each output is compared
with the kept form's.  K5 and K7 (kernels k5, k7): K7 (encode_kf_frame)
on frame 0 one-pass at qi 24 and two-pass at qi 32, K8 rt on frame 1 (its
intra macroblocks run K7's B_PRED chain), K5 (loop_filter) on the
single-frame decoder's frame 1 and on the encoders' 8-level search call;
K7's "clocked" variant adds thread 0's clock64() per phase and prints
cycles a macroblock.  K8 and K9 (kernels k8): K8 (encode_inter_frame) best
and rt at qi 48, the rt pair, seeded extreme motion, K9
(decide_inter_frame) one quantizer and the pair; its "clocked" variant
prints K8's phases.  K1 and K10 (kernels k1): K1 (wavefront_decode) on
the GOP decoder's 720p G=16 interframe and key frame, K10
(intra_fixup_frame) on the fast path's 720p frame 1, pair and scene cut and
176x144.  The pairs (kernels pairs, with --parent): each case of K10, K4,
K5, K1 and K8 timed from DIR's library and from this checkout's, alternating
which goes first, 12 readings a side (DIR's K1 and K10 through their
parent's wrappers, which the entries' arguments of this checkout no longer
fit).  Prints JSON lines;
exits non-zero without a CUDA device or if a variant does not build or its
output differs.

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
    enc_intra_cuda, enc_intra_fixup_cuda, intra_cuda, lf_cuda, \
    wavefront_cuda  # noqa: E402

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


# the kernels a redesign of K1 and K10 leaves alone: K4's and K5's in the
# library they share with K1, and K7's, K8's and K9's libraries
SAME_SASS = {"wavefront": ("untile_kernel", "intra_diag_kernel",
                           "lf_row_kernel"),
             "enc_intra": None, "enc_inter": None, "enc_decide": None}


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


K1_PHASES = ("before_wait", "wait", "loads", "intra_dc", "intra_rows",
             "bpred_chain", "intra_pack", "intra_vertical", "horizontal",
             "stores_publish")


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
    s = rep(s, "      const int dc = dc_value(sa, sl, hrow_mb, c > 0, luma ? 4 : 3);\n",
            "      const int dc = dc_value(sa, sl, hrow_mb, c > 0, luma ? 4 : 3);\n"
            "      K1_TICK(3)\n")
    s = rep(s, "      if (bpred) {\n        __syncwarp();\n",
            "      K1_TICK(4)\n      if (bpred) {\n        __syncwarp();\n")
    s = rep(s, "          for (int k = 0; k < 16; ++k) own[k] = s_t[1 + row][1 + k];\n"
               "        }\n      }\n",
            "          for (int k = 0; k < 16; ++k) own[k] = s_t[1 + row][1 + k];\n"
            "        }\n        K1_TICK(5)\n      }\n")
    s = rep(s, "      lu = (luma ? u[3] : u[1]) >> 24;\n      __syncwarp();\n",
            "      lu = (luma ? u[3] : u[1]) >> 24;\n      __syncwarp();\n"
            "      K1_TICK(6)\n")
    s = rep(s, "    __syncwarp();\n    if (on)\n      lf_filter_window(s_y, s_u, "
               "s_v, lane, do_left, do_top, do_sb, p[5],\n                       "
               "p[6], p[7], p[8], false, true);\n",
            "    __syncwarp();\n    K1_TICK(7)\n    if (on)\n      "
            "lf_filter_window(s_y, s_u, s_v, lane, do_left, do_top, do_sb, "
            "p[5],\n                       p[6], p[7], p[8], false, true);\n"
            "    K1_TICK(8)\n")
    return rep(s, "    if (lane == 0) row_publish(prog, c + 1);\n  }\n}",
               "    if (lane == 0) row_publish(prog, c + 1);\n    K1_TICK(9)\n"
               "  }\n  if (lane == 0) {\n    for (int k = 0; k < 10; ++k)\n"
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
                    per = [n] * 3 + [max(n_intra, 1)] * 2 + [max(n_bpred, 1)] \
                        + [max(n_intra, 1)] * 2 + [n] * 2
                    cs.say("ablation_k1_phases", case=case, card=card,
                           macroblocks=n, intra=n_intra, b_pred=n_bpred,
                           cycles_per_macroblock={
                               p: buf[i] / per[i]
                               for i, p in enumerate(K1_PHASES)})
    finally:
        wavefront_cuda._entry, enc_intra_fixup_cuda._entry = saved
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
    ap.add_argument("--kernels", default="k1,k7,k5,k8,pairs",
                    help="comma-separated: k1 (K1's and K10's variants), k7 "
                         "(K7's clocked phases), k5 (K7's and K5's "
                         "variants), k8 (K8's and K9's, with --parent also "
                         "the machine code), sass (the machine code alone, "
                         "with --parent), pairs (with --parent: K10, K4, K5, "
                         "K1 and K8 timed from the parent's library and this "
                         "one's in alternation)")
    ap.add_argument("--pairs", type=int, default=12,
                    help="readings of each side in the pairs")
    args = ap.parse_args()
    kernels = set(args.kernels.split(","))
    card = cs.smi()
    cs.say("ablation_env", card=card, device=torch.cuda.get_device_name(0))
    os.makedirs(OUT, exist_ok=True)
    ok = True
    if "k1" in kernels:
        ok &= run_k1_k10(card)
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


# ---- the kernels this redesign holds to the parent: each case timed from
# the parent's library and from this checkout's in alternation

# C entry: (the argument types this checkout's wrapper gives it, the
# wrapper's module)
PAIR_ENTRIES = {
    "intra_fixup_frame_launch": (enc_intra_fixup_cuda.ARGTYPES,
                                 enc_intra_fixup_cuda),
    "encode_inter_frame_launch": (ENTRIES["enc_inter"][1], enc_inter_cuda),
    "intra_frame_launch": (wavefront_cuda.WAVE_ARGTYPES, intra_cuda),
    "wavefront_decode_launch": (wavefront_cuda.ARGTYPES, wavefront_cuda),
    "loop_filter_launch": (lf_cuda.ARGTYPES, lf_cuda),
}


def parent_k1(entry):
    """K1's wrapper as the parent had it, around the parent's ``entry``
    (planes out, tiles, residuals, words, bmode; G, R, C)."""
    def wrapper(y, u, v, res_y, res_u, res_v, ymode, uvmode, bmode,
                has_nonzero, intra_mask, lf_params):
        G, R, C = ymode.shape
        mbp = wavefront_cuda.pack_mb_params(ymode, uvmode, has_nonzero,
                                            intra_mask, lf_params)
        Y, U, V = wavefront_cuda.empty_planes(G, R, C, y.device)
        _build.launch(entry, "parent wavefront_decode", y.device,
                      *(t.data_ptr() for t in (Y, U, V, y, u, v, res_y,
                                               res_u, res_v, mbp, bmode)),
                      G, R, C)
        return Y, U, V
    return wrapper


def parent_k10(entry):
    """K10's wrapper as the parent had it, around the parent's ``entry``
    (originals, decisions, planes encoded in place, coefficients, modes,
    scalars, mode costs; Q, R, C): the planes cloned, the coefficients and
    modes zeroed."""
    def wrapper(oy, ou, ov, md, y, u, v, scalars, mbc):
        Q, R, C = md.shape[:3]
        Y, U, V = y.clone(), u.clone(), v.clone()
        coeffs = torch.zeros((Q, R, C, 25, 16), dtype=torch.int16,
                             device=oy.device)
        modes = torch.zeros((Q, R, C, 3), dtype=torch.int32, device=oy.device)
        _build.launch(entry, "parent intra_fixup_frame", oy.device,
                      *(t.data_ptr() for t in (oy, ou, ov, md, Y, U, V,
                                               coeffs, modes, scalars, mbc)),
                      Q, R, C)
        return coeffs, modes, Y, U, V
    return wrapper


# the parent's argument types and wrappers of the entries whose arguments
# this checkout changed
PARENT_WRAPPERS = {
    "wavefront_decode_launch": (wavefront_cuda.WAVE_ARGTYPES, parent_k1),
    "intra_fixup_frame_launch": ([_PTR] * 11 + [_INT] * 3, parent_k10),
}


def pair_cases():
    """[(source, C entry, case, wrapper, args)]: K10 on the fast path's four
    cases, K4, K5 and K1 on the decoders' 720p frames (K5 also on the
    encoders' loop-filter search call), K8 on chip_smoke.py's 720p and
    176x144 cases."""
    ivf = cs.IVFReader(cs.CLIP)
    payloads = [ivf.frame(i) for i in range(len(ivf))]
    sm = cs.decoded_frames(cs.SMALL_CLIP, (0, 1))
    big = cs.decoded_frames(cs.CLIP, (0, 1, 5))
    out = []
    for label, (k, f, key_qi, qis) in {
            "720p frame1 qi48": (0, 1, 48, [cs.FAST_QI]),
            "720p pair": (0, 1, cs.FAST_PAIR_KEY_QI, cs.FAST_PAIR_QIS),
            "720p scene cut": (5, 0, 48, [cs.FAST_QI]),
            "176x144 frame1 qi48": (None, None, 48, [cs.FAST_QI])}.items():
        a, b = (sm[0], sm[1]) if k is None else (big[k], big[f])
        out.append(("enc_intra_fixup", "intra_fixup_frame_launch",
                    "k10 " + label, enc_intra_fixup_cuda.intra_fixup_frame,
                    cs.fast_kernel_inputs(a, b, key_qi, qis)[1]))
    sf = cs.single_frame_kernel_inputs(payloads[:2], ivf.width, ivf.height)
    for f, label in ((1, "interframe"), (0, "key frame")):
        out.append(("wavefront", "intra_frame_launch", "k4 720p " + label,
                    intra_cuda.intra_frame, sf[("intra_frame", f)][0]))
    for label, args in (("frame 1", sf[("loop_filter", 1)][0]),
                        ("key frame qi24 search",
                         cs.k5_search_inputs(big[0], 24))):
        out.append(("wavefront", "loop_filter_launch", "k5 720p " + label,
                    lf_cuda.loop_filter, args))
    kept = cs.real_kernel_inputs(payloads, ivf.width, ivf.height, cs.G)
    for key, label in (("wave_inter", "interframe"), ("wave_key", "key frame")):
        out.append(("wavefront", "wavefront_decode_launch",
                    "k1 720p G=16 " + label, wavefront_cuda.wavefront_decode,
                    kept[key]))
    for label, args in (
            ("720p best", cs.k8_args(big[0], big[1], 48, [48])),
            ("720p rt", cs.k8_args(big[0], big[1], 48, [48], "rt")),
            ("720p pair", cs.k8_args(big[0], big[1], cs.INTER_PAIR_KEY_QI,
                                     cs.INTER_PAIR_QIS, "rt")),
            ("720p extreme", cs.k8_extreme(44)),
            ("176x144 best", cs.k8_args(sm[0], sm[1], 48, [48])),
            ("176x144 rt", cs.k8_args(sm[0], sm[1], 48, [48], "rt")),
            ("176x144 two-pass", cs.k8_args(sm[0], sm[1], 32, [32],
                                            two_pass=True))):
        out.append(("enc_inter", "encode_inter_frame_launch", "k8 " + label,
                    enc_inter_cuda.encode_inter_frame, args))
    return out


def parent_pairs(card, parent, pairs):
    """Each pair_cases() case timed ``pairs`` times from the parent's
    library and from this checkout's, alternating which goes first, each
    reading the median of 10 calls: the medians of each side's readings,
    their spread, and whether the two outputs are equal."""
    jobs = [(os.path.join(OUT, "pairs", tag, "lib%s.so" % src),
             os.path.join(d, src + ".cu"))
            for src in ("enc_intra_fixup", "enc_inter", "wavefront")
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
    for src, fn, case, wrapper, args in pair_cases():
        types, mod = PAIR_ENTRIES[fn]
        here = typed("here", src, fn, types)
        calls = {"here": wrapper}
        if fn in PARENT_WRAPPERS:
            ptypes, make = PARENT_WRAPPERS[fn]
            calls["parent"] = make(typed("parent", src, fn, ptypes))
            parent = here
        else:
            calls["parent"] = wrapper
            parent = typed("parent", src, fn, types)
        entries = {"here": here, "parent": parent}
        saved = mod._entry
        outs, ms = {}, {"parent": [], "here": []}
        try:
            for i in range(pairs):
                for tag in (("parent", "here") if i % 2 == 0
                            else ("here", "parent")):
                    mod._entry = lambda t=tag: entries[t]
                    call = calls[tag]
                    if tag not in outs:
                        outs[tag] = call(*args)
                    ms[tag].append(cs.time_ms(lambda: call(*args), 10))
        finally:
            mod._entry = saved
        tup = lambda x: x if isinstance(x, tuple) else (x,)
        equal = all(torch.equal(x, y) for x, y in
                    zip(tup(outs["parent"]), tup(outs["here"])))
        ok &= equal
        med = {t: statistics.median(v) for t, v in ms.items()}
        cs.say("ablation_pairs", case=case, card=card, pairs=pairs,
               equal=equal, median_parent=med["parent"],
               median_here=med["here"], ratio=med["here"] / med["parent"],
               range_parent=[min(ms["parent"]), max(ms["parent"])],
               range_here=[min(ms["here"]), max(ms["here"])])
    return ok


if __name__ == "__main__":
    main()
