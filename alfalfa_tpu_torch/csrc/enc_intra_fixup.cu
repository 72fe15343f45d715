// intra_fixup_frame (K10): the whole-mode intra encode of the macroblocks
// a fast rt interframe's decisions (K9) left intra, on the card, against
// their neighbours' final reconstruction, for one or several quantizers at
// once: DC / V / H / TM by variance rd-cost under the interframe's mode
// costs, the Y2 luma chain, the chroma mode of least SSE and its chain,
// plain quantization (the JAX package's encode_intra_np.encode_intra_mb with
// interframe=True, skip_bpred=True; plain version
// ops/enc_intra_fixup.py:intra_fixup_frame_plain).
//
// Replaces the TPU kernel alfalfa_tpu/ops/enc_intra_fixup_pallas.py:
// intra_fixup_frame (_fixup_kernel), with H1 (enc_transforms.cuh) inside.
// Kept from it: the arithmetic, the 127 / 129 edge rules (the TM corner
// 127 on the top row, 129 on the left column below it), the whole-mode scan
// from INF = 1 << 30 with strict '<', the chroma mode by SSE, and the
// outputs (coefficients and modes only for intra macroblocks).  Not kept:
// the raster walk over a reconstruction scratch (an intra macroblock reads
// only its left, above and above-left neighbours, all on the earlier
// anti-diagonal d = row + col, so here a diagonal is one launch and the
// planes are encoded in place: inter macroblocks are final already), the
// tile and block layouts with their permutation matmuls, and the vmap over
// quantizers (here blockIdx.y).
//
// Design: K7's macroblock steps (enc_mb_device.cuh: mb_load,
// whole_luma_costs, y2_path, chroma_mode, chroma_code) without B_PRED and
// the trellis: one launch per diagonal, a block of 256 threads per
// (macroblock, quantizer); an inter macroblock's block returns at once.
// mb_load also reads the above-right pixels, which B_PRED alone uses: on
// the same diagonal they may be in flight, and nothing here reads them.
// Launches per call: R + C - 1, whatever the number of quantizers.
//
// Bound: bytes for a frame with few intra macroblocks (the planes copied
// once by the wrapper, the decisions read); per intra macroblock, K7's
// whole-mode and chroma searches and 25 transform chains.  In practice the
// R + C - 1 dependent launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "enc_mb_device.cuh"  // the macroblock steps K10 shares with K7, K8

#define DECIDE_WORDS 8  // K9's words per macroblock; word 0: is_inter
#define FIXUP_WORDS 3   // whole mode, chroma mode, any nonzero coefficient
#define N_SCALARS 9     // y_dc, y_ac, y2_dc, y2_ac, uv_dc, uv_ac, rate and
                        // distortion multipliers, SAD per bit
#define FIXUP_INF (1LL << 30)

struct FixupArgs {
  MbPlanes p;          // originals; quantizer 0's planes, encoded in place
                       // (the kernel offsets them by blockIdx.y)
  const int* md;       // (Q,R,C,DECIDE_WORDS) K9's decisions
  int16_t* coeffs;     // (Q,R,C,25,16) raster order, zero at inter MBs
  int* modes;          // (Q,R,C,FIXUP_WORDS), zero at inter MBs
  const int* scalars;  // (Q,N_SCALARS)
  const int* mbc;      // interframe macroblock mode costs (5)
};

// One block per (macroblock of diagonal d, quantizer blockIdx.y):
// r = r_lo + blockIdx.x, c = d - r.
__global__ void __launch_bounds__(256) enc_fixup_diag_kernel(FixupArgs a,
                                                             int d,
                                                             int r_lo) {
  const int r = r_lo + blockIdx.x, c = d - r, qp = blockIdx.y;
  const int tid = threadIdx.x;
  MbPlanes P = a.p;
  const int R = P.R, C = P.C, W = C * 16;
  const size_t n_mb = (size_t)R * C;
  const int mb = r * C + c;
  if (a.md[(qp * n_mb + mb) * DECIDE_WORDS] != 0) return;  // inter: final
  P.ry += qp * n_mb * 256;
  P.ru += qp * n_mb * 64;
  P.rv += qp * n_mb * 64;
  const int* sc = a.scalars + qp * N_SCALARS;
  for (int i = 0; i < 6; ++i) P.q[i] = sc[i];
  P.rm = sc[6];
  P.dm = sc[7];

  MB_SHARED(s);
  mb_load(P, s, r, c);
  __syncthreads();                                   // the DC values
  whole_luma_costs(P, s, a.mbc, FIXUP_INF);   // s.dec[0]
  y2_path(P, s, false, WholePred{s.dec[0]});
  chroma_mode(s);
  chroma_code(P, s, r, c, false, WholePred{s.dec[1]});

  int16_t* co = a.coeffs + (qp * n_mb + mb) * 400;
  int any = 0;
  for (int i = tid; i < 400; i += 256) {
    const int blk = i >> 4, p = i & 15;
    const int v = blk < 16 ? s.wco[blk][p] : blk < 24 ? s.uvco[blk - 16][p]
                                                      : s.y2[p];
    co[i] = (int16_t)v;
    any |= v != 0;
  }
  const int py = tid >> 4, px = tid & 15;
  P.ry[(size_t)(r * 16 + py) * W + c * 16 + px] = (uint8_t)s.t[1 + py][1 + px];
  const int nz = __syncthreads_or(any);
  if (tid == 0) {
    int* m = a.modes + (qp * n_mb + mb) * FIXUP_WORDS;
    m[0] = s.dec[0];
    m[1] = s.dec[1];
    m[2] = nz != 0;
  }
}

// Enqueue the R + C - 1 diagonal launches of one frame at Q quantizers on
// ``stream`` (grid: the diagonal's macroblocks x Q); y / u / v hold the
// inter macroblocks' reconstruction and receive the intra ones'; coeffs
// and modes are zero on entry.  Writes the number of kernel launches
// issued to ``*n_launched`` and returns cudaGetLastError() after the last
// one.
extern "C" int intra_fixup_frame_launch(
    const void* oy, const void* ou, const void* ov, const void* md, void* y,
    void* u, void* v, void* coeffs, void* modes, const void* scalars,
    const void* mbc, int Q, int R, int C, void* stream, int* n_launched) {
  FixupArgs a;
  MbPlanes& p = a.p;
  p.oy = (const uint8_t*)oy; p.ou = (const uint8_t*)ou; p.ov = (const uint8_t*)ov;
  p.ry = (uint8_t*)y; p.ru = (uint8_t*)u; p.rv = (uint8_t*)v;
  p.tc = nullptr;
  p.vcost = nullptr;
  p.ynz = p.unz = p.vnz = p.y2c = nullptr;
  p.R = R; p.C = C;
  for (int i = 0; i < 6; ++i) p.q[i] = 0;  // per quantizer, from scalars
  p.rm = p.dm = 0;
  a.md = (const int*)md;
  a.coeffs = (int16_t*)coeffs;
  a.modes = (int*)modes;
  a.scalars = (const int*)scalars;
  a.mbc = (const int*)mbc;
  cudaStream_t st = (cudaStream_t)stream;
  int issued = 0;
  for (int d = 0; d < R + C - 1; ++d) {
    const int r_lo = d - C + 1 > 0 ? d - C + 1 : 0;
    const int r_hi = d < R - 1 ? d : R - 1;
    enc_fixup_diag_kernel<<<dim3(r_hi - r_lo + 1, Q), 256, 0, st>>>(a, d,
                                                                     r_lo);
    ++issued;
  }
  *n_launched = issued;
  return (int)cudaGetLastError();
}
