// encode_kf_frame (K7): the keyframe encoder's macroblock loop on the card.
// Mode decision, transforms, quantization (plain or trellis) and the
// decoder-identical reconstruction of every macroblock of a key frame, over
// anti-diagonals d = 2*row + col (reference encoder/encode_intra.cc:36-456;
// plain version ops/enc_intra.py:encode_kf_frame_plain).
//
// Replaces the TPU kernel alfalfa_tpu/ops/enc_intra_pallas.py:
// encode_kf_frame (_enc_kernel), with the helpers traced inside it: H1
// (enc_transforms_pallas.py -> enc_transforms.cuh) and H2
// (trellis_pallas.py -> trellis.cuh).  Kept from it: the arithmetic, every
// tie-break (modes scanned ascending with strict '<', B_PRED only if
// strictly cheaper) and the wavefront order.  Not kept: the skewed
// diagonal storage, the rings of slabs, the permutation matmuls between
// tile and block layouts, the one-hot matmul for the contextual b-mode
// costs and the int32 cost argument: here the planes and per-macroblock
// state live in device memory, a block addresses its neighbours directly,
// tables are read by index and costs are int64.  For whole-macroblock luma
// the TPU kernel runs 16 trellis walks under all three entry contexts and
// picks afterwards; here the 16 blocks run in raster order, each under the
// context its neighbours' final flags give.
//
// Design (simple and right first): one launch per diagonal, one block of
// 256 threads per macroblock; the macroblock steps are in
// enc_mb_device.cuh, shared with the interframe encoder (enc_inter.cu).
// The ten b-mode predictions of a sub-block are 160 threads (mode * 16 + pixel) with a 16-lane shuffle reduction of
// the SSE; one thread then picks the mode and runs the sub-block's
// transform chain, since the next sub-block predicts from its
// reconstruction.  Whole-mode variances are 256 threads (one a pixel) with
// a block reduction; the whole-mode transforms are 16 threads (one a
// block), the trellis chains one thread each (luma, Y2) or two (U and V
// side by side).  Neighbour state in device memory, written by earlier
// diagonals: the unfiltered reconstruction planes, the per-macroblock
// modes (b-mode context) and, for the trellis, the per-4x4 nonzero flags
// and the Y2 context chains.  Launches per call: 2*(R-1) + C.
//
// Bound: on paper device memory (the original planes in, coefficients,
// modes and reconstruction out: about 4.6 bytes per luma pixel); in
// practice the critical path: the serial chain of 16 sub-blocks per
// macroblock, each a mode search, a transform chain in one thread and two
// barriers, repeated over 2*(R-1) + C dependent launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "enc_mb_device.cuh"  // the macroblock steps K7 shares with K8

#define MODE_WORDS 20  // ymode, uvmode, y2_coded, has_nonzero, 16 b-modes

struct EncArgs {
  MbPlanes p;                   // planes, trellis state, quantizers
  int16_t* coeffs;              // (R,C,25,16) raster order
  uint8_t* modes;               // (R,C,MODE_WORDS)
  const int* mbc;               // key-frame macroblock mode costs (5)
  const int* bcost;             // b-mode costs [above][left][mode] (1000)
};

// One block per macroblock of diagonal d: r = r_lo + blockIdx.x, c = d - 2r.
__global__ void __launch_bounds__(256) enc_kf_diag_kernel(EncArgs a, int d,
                                                          int r_lo) {
  const int r = r_lo + blockIdx.x, c = d - 2 * r;
  const int tid = threadIdx.x;
  // a copy, not a reference: its fields stay in registers along the
  // one-thread chains instead of being read from the parameters again
  const MbPlanes P = a.p;
  const int C = P.C, W = C * 16;
  const int mb = r * C + c;
  const bool trellis = P.tc != nullptr;
  MB_SHARED(s);

  // the b-mode context: the above MB's bottom row, the left one's right
  // column (B_DC_PRED, 0, off the frame)
  if (tid >= 128 && tid < 132) {
    const int k = tid - 128;
    s.nbm[k] = r > 0 ? a.modes[(size_t)(mb - C) * MODE_WORDS + 4 + 12 + k] : 0;
  } else if (tid >= 132 && tid < 136) {
    const int k = tid - 132;
    s.nbm[4 + k] = c > 0 ? a.modes[(size_t)(mb - 1) * MODE_WORDS + 4 + 4 * k + 3] : 0;
  }
  mb_load(P, s, r, c);
  intra_mb(P, s, r, c, a.mbc, a.bcost, true);
  const bool use_b = s.dec[0] != 0;
  const int wm = s.dec[1], um = s.dec[2];

  // ---- outputs: coefficients, modes, luma, the trellis state ----
  int any = 0;
  for (int i = tid; i < 400; i += 256) {
    const int blk = i >> 4, p = i & 15;
    int v;
    if (blk < 16) v = use_b ? s.bco[blk][p] : s.wco[blk][p];
    else if (blk < 24) v = s.uvco[blk - 16][p];
    else v = use_b ? 0 : s.y2[p];
    a.coeffs[(size_t)mb * 400 + i] = (int16_t)v;
    any |= v != 0;
  }
  P.ry[(size_t)(r * 16 + (tid >> 4)) * W + c * 16 + (tid & 15)] =
      (uint8_t)s.t[1 + (tid >> 4)][1 + (tid & 15)];
  const int has_nonzero = __syncthreads_or(any);
  uint8_t* md = a.modes + (size_t)mb * MODE_WORDS;
  if (tid < 16) {
    md[4 + tid] = (uint8_t)(use_b ? s.bm[tid] : imode_to_bmode(wm));
  } else if (tid == 16) {
    md[0] = (uint8_t)(use_b ? B_PRED : wm);
    md[1] = (uint8_t)um;
    md[2] = (uint8_t)!use_b;
    md[3] = (uint8_t)(has_nonzero != 0);
  }
  if (trellis) {
    const int C4 = 4 * C, C2 = 2 * C;
    if (tid >= 32 && tid < 48) {
      const int b = tid - 32, sr = b >> 2, sc = b & 3;
      P.ynz[(size_t)(4 * r + sr) * C4 + 4 * c + sc] = use_b ? s.bnz[b] : s.wnz[b];
    } else if (tid >= 64 && tid < 72) {
      const int k = tid - 64, pl = k >> 2, b = k & 3;
      (pl ? P.vnz : P.unz)[(size_t)(2 * r + (b >> 1)) * C2 + 2 * c + (b & 1)] = s.uvnz[k];
    } else if (tid == 96) {
      // a B_PRED macroblock has no Y2: it passes its neighbours' on
      uint8_t* y2 = P.y2c + (size_t)mb * 4;
      y2[0] = use_b ? s.ctx[16] : s.y2nz;
      y2[1] = use_b ? s.ctx[17] : 1;
      y2[2] = use_b ? s.ctx[18] : s.y2nz;
      y2[3] = use_b ? s.ctx[19] : 1;
    }
  }
}

// Enqueue the 2*(R-1) + C diagonal launches of one frame on ``stream``;
// writes the number of kernel launches issued to ``*n_launched`` and
// returns cudaGetLastError() after the last one.  ``tc`` null: plain
// quantization (then vcost and the flag buffers are not read).
extern "C" int encode_kf_frame_launch(
    const void* oy, const void* ou, const void* ov, void* ry, void* ru,
    void* rv, void* coeffs, void* modes, const void* mbc, const void* bcost,
    const void* tc, const void* vcost, void* ynz, void* unz, void* vnz,
    void* y2c, int ydc, int yac, int y2dc, int y2ac, int uvdc, int uvac,
    int rm, int dm, int R, int C, void* stream, int* n_launched) {
  EncArgs a;
  MbPlanes& p = a.p;
  p.oy = (const uint8_t*)oy; p.ou = (const uint8_t*)ou; p.ov = (const uint8_t*)ov;
  p.ry = (uint8_t*)ry; p.ru = (uint8_t*)ru; p.rv = (uint8_t*)rv;
  p.tc = (const int*)tc;
  p.vcost = (const int*)vcost;
  p.ynz = (uint8_t*)ynz; p.unz = (uint8_t*)unz; p.vnz = (uint8_t*)vnz;
  p.y2c = (uint8_t*)y2c;
  p.R = R; p.C = C;
  const int q[6] = {ydc, yac, y2dc, y2ac, uvdc, uvac};
  for (int i = 0; i < 6; ++i) p.q[i] = q[i];
  p.rm = rm; p.dm = dm;
  a.coeffs = (int16_t*)coeffs;
  a.modes = (uint8_t*)modes;
  a.mbc = (const int*)mbc;
  a.bcost = (const int*)bcost;
  cudaStream_t st = (cudaStream_t)stream;
  int issued = 0;
  const int nd = 2 * (R - 1) + C;
  for (int d = 0; d < nd; ++d) {
    const int lo = d - C + 1;
    const int r_lo = lo > 0 ? (lo + 1) / 2 : 0;
    const int r_hi = d / 2 < R - 1 ? d / 2 : R - 1;
    const int n = r_hi - r_lo + 1;
    if (n <= 0) continue;
    enc_kf_diag_kernel<<<n, 256, 0, st>>>(a, d, r_lo);
    ++issued;
  }
  *n_launched = issued;
  return (int)cudaGetLastError();
}
