#!/usr/bin/env python3
"""Ablation of the persistent K8 / K9 kernels' steps on one NVIDIA GPU.

    python3 chip_ablation.py                  # from the repo root
    python3 chip_ablation.py --parent DIR     # also: K7's and K10's machine
                                              # code against DIR's sources

Writes variants of alfalfa_tpu_torch/csrc/ into build/ablation/<variant>/,
each the sources with one step of the redesign undone (or, for
"separable", one tried step added), builds them all at once (one nvcc per
source) and times K8 (encode_inter_frame) and K9 (decide_inter_frame) on
720p inputs chip_smoke.py makes (frame 1 after frame 0 as a key frame, best
and rt at qi 48, the rt pair, seeded extreme motion; K9 one quantizer and
the pair), every variant in one process, "kept" first and last for the
spread; each output is compared with the kept form's.  The "clocked"
variant adds thread 0's clock64() per phase of K8 and prints cycles a
macroblock.  Prints JSON lines; exits non-zero without a CUDA device or if
a variant does not build or its output differs.

The variants are text edits of the current sources: an edit that no longer
applies fails loudly, and the script then describes an earlier design.
"""
import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from alfalfa_tpu_torch import _build  # noqa: E402
from alfalfa_tpu_torch.ops import enc_decide_cuda, enc_inter_cuda  # noqa: E402

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
    s = rep(s, "    const bool use_b = !inter && s.dec[0] != 0;\n",
            "    TICK(4)\n    const bool use_b = !inter && s.dec[0] != 0;\n")
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


def write_variants():
    for name, edits in VARIANTS.items():
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


def entry(name, src):
    """The C entry of variant ``name``'s ``src`` library, typed as the
    wrapper types it."""
    lib = ctypes.CDLL(os.path.join(OUT, name, "lib%s.so" % src))
    if src == "enc_inter":
        f, n_ptr, n_int = lib.encode_inter_frame_launch, 24, 4
    else:
        f, n_ptr, n_int = lib.decide_inter_frame_launch, 9, 3
    f.restype = ctypes.c_int
    f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                  + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                     ctypes.POINTER(ctypes.c_int)])
    return f


def same_sass(parent):
    """K7's and K10's machine code from ``parent``'s sources and from this
    checkout's: {source: (instructions parent, here, identical)}."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = {}
    for src in ("enc_intra", "enc_intra_fixup"):
        jobs = [(os.path.join(OUT, "%s_%s.so" % (tag, src)),
                 os.path.join(d, src + ".cu"))
                for tag, d in (("parent", os.path.join(
                    parent, "alfalfa_tpu_torch", "csrc")),
                    ("here", _build.CSRC_DIR))]
        build(jobs)
        sass = [[l for l in subprocess.run(
            [cuobjdump, "-sass", so], capture_output=True, text=True,
            check=True).stdout.splitlines() if "/*" in l]
            for so, _ in jobs]
        out[src] = (len(sass[0]), len(sass[1]), sass[0] == sass[1])
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_ablation.py needs a CUDA device")
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="a checkout of the parent commit")
    args = ap.parse_args()
    card = cs.smi()
    cs.say("ablation_env", card=card, device=torch.cuda.get_device_name(0))
    os.makedirs(OUT, exist_ok=True)
    write_variants()
    t0 = time.perf_counter()
    logs = build([(os.path.join(OUT, n, "lib%s.so" % src),
                   os.path.join(OUT, n, src + ".cu"))
                  for n in VARIANTS for src in SOURCES])
    cs.say("ablation_build", seconds=time.perf_counter() - t0,
           ptxas={os.path.relpath(k, OUT): v for k, v in logs.items()})
    if args.parent:
        cs.say("ablation_sass", **{k: {"instructions_parent": a,
                                       "instructions_here": b,
                                       "identical": same}
                                   for k, (a, b, same) in
                                   same_sass(args.parent).items()})

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
    if not ok:
        raise SystemExit("a variant's output differs from the kept form's")


if __name__ == "__main__":
    main()
