// inter_residues: the rebase's residue update of every inter macroblock of
// one frame in one launch.
//
// Replaces no pallas_call: the JAX package computes this step with XLA
// (alfalfa_tpu/encoder/reencode_device.py:_fn_core), calling the H1
// helpers of alfalfa_tpu/ops/enc_transforms_pallas.py on every block of
// the frame around K3's prediction.  The port runs it as this kernel so
// that the rebase's hot path is two launches a frame (K3, then this), not
// some hundred eager PyTorch ops.  The plain version is
// ops/rebase.py:inter_residues_plain; the wrapper ops/rebase_cuda.py.
//
// Semantics (reference reencode.cc:162-210): for each inter macroblock
// (ref_sel != 0) the original minus K3's prediction goes through the
// forward DCT and truncating quantization; a whole-vector macroblock's 16
// luma DCs go through the forward WHT into Y2 (its luma blocks code AC
// only), a SPLITMV macroblock keeps them in-block and codes Y2 as zeros;
// then the decoder's reconstruction of what was coded (dequantize, inverse
// WHT of Y2 into the luma DCs, inverse DCT, add to the prediction, clamp)
// is written into the reconstruction planes.  Coefficients come out as
// 25 blocks of 16 a macroblock: 16 luma, 4 U, 4 V, Y2.  Intra macroblocks
// are left to the host: their coefficients and nonzero flag are written
// as zeros, their reconstruction is not touched.
//
// Design (the simple form: right first): a block of 384 threads per
// macroblock, a 16-lane half-warp per 4x4 sub-block (16 luma, 4 U, 4 V),
// one coefficient a lane, through H1's lane-parallel helpers
// (enc_transforms.cuh: fdct4x4_lane, quantize_lane, dequantize_lane,
// idct4x4_lane, whose row and column passes are shuffles inside the
// half-warp).  The luma DCs go through shared memory to thread 0, which
// runs the WHT, quantizes and dequantizes Y2 and its inverse WHT
// (fwht4x4, quantize4x4, dequantize4x4, iwht4x4); __syncthreads_or gives
// the macroblock's nonzero flag.  Not done yet: K3 fused in (its
// prediction makes a round trip through device memory), several
// macroblocks a block.
//
// Bound: memory.  Per 720p frame it must read the originals and the
// predictions (1.38 MB each) and write the coefficients (2.88 MB) and the
// reconstruction (1.38 MB): about 7 MB, 2.1 us at 3.35 TB/s.  A call this
// small is bound by its launch in practice.

#include <cuda_runtime.h>
#include <stdint.h>

#include "enc_transforms.cuh"

namespace {

constexpr int RES_THREADS = 384;   // 24 sub-blocks x 16 lanes

struct ResidueArgs {
  const uint8_t* orig[3];   // planes of pitch C * S (S = 16, 8, 8)
  const uint8_t* pred[3];   // tiles: macroblock m at pred[k] + m * pred_mb[k]
  long long pred_mb[3];     // rows of S bytes inside a tile
  uint8_t* recon[3];        // planes of pitch C * S, written at inter MBs
  const int* ref_sel;       // (R, C), 0 = intra
  const uint8_t* splitmv;   // (R, C) bool
  int16_t* coeffs;          // (R, C, 25, 16)
  uint8_t* nonzero;         // (R, C) bool
  int q[6];                 // y_dc, y_ac, y2_dc, y2_ac, uv_dc, uv_ac
  int R, C;
};

__global__ void __launch_bounds__(RES_THREADS)
inter_residues_kernel(ResidueArgs a) {
  const int mb = blockIdx.x;
  const int t = threadIdx.x, b = t >> 4, p = t & 15;
  int16_t* co_out = a.coeffs + (size_t)mb * 400;
  if (a.ref_sel[mb] == 0) {        // intra: the host loop's (block-uniform)
    co_out[t] = 0;
    if (t < 16) co_out[384 + t] = 0;
    if (t == 0) a.nonzero[mb] = 0;
    return;
  }
  const bool split = a.splitmv[mb] != 0;
  const int r = mb / a.C, c = mb - r * a.C;
  const int k = b < 16 ? 0 : b < 20 ? 1 : 2;      // warp-uniform
  const int S = k ? 8 : 16, nb = S >> 2;
  const int sb = k ? (b - 16) & 3 : b;
  const int ty = ((sb / nb) << 2) + (p >> 2), tx = ((sb % nb) << 2) + (p & 3);
  const size_t px = (size_t)(r * S + ty) * (a.C * S) + c * S + tx;
  const int o = a.orig[k][px];
  const int pr = a.pred[k][mb * a.pred_mb[k] + ty * S + tx];

  __shared__ int dcs[16], y2q[16], dc_rec[16];
  const int co = fdct4x4_lane(o - pr, p);
  if (k == 0 && p == 0) dcs[b] = co;
  const int dcf = k ? a.q[4] : a.q[0], acf = k ? a.q[5] : a.q[1];
  const int f = p ? acf : dcf;
  // a whole-vector macroblock's luma DC rides Y2
  const int qv = (k == 0 && p == 0 && !split) ? 0
                                                : quantize_lane(co, quantize_inv(f));
  co_out[b * 16 + p] = (int16_t)qv;
  __syncthreads();

  bool nz = qv != 0;
  if (t == 0) {
    int y2[16], y2d[16];
    if (split) {
      for (int i = 0; i < 16; ++i) y2q[i] = 0;
    } else {
      fwht4x4(dcs, y2);
      int yq[16];
      quantize4x4(y2, a.q[2], a.q[3], yq);
      for (int i = 0; i < 16; ++i) {
        y2q[i] = yq[i];
        nz |= yq[i] != 0;
      }
      dequantize4x4(yq, a.q[2], a.q[3], y2d);
      iwht4x4(y2d, y2);
      for (int i = 0; i < 16; ++i) dc_rec[i] = y2[i];
    }
  }
  const int any = __syncthreads_or(nz);
  if (t < 16) co_out[384 + t] = (int16_t)y2q[t];
  if (t == 0) a.nonzero[mb] = any != 0;

  // the decoder's reconstruction of what was coded
  int dq = dequantize_lane(qv, f);
  if (k == 0 && p == 0 && !split) dq = dc_rec[b];
  const int res = idct4x4_lane(dq, p);
  const int v = pr + res;
  a.recon[k][px] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

}  // namespace

// p: the parameter words: orig[3], pred[3], pred_mb[3], recon[3], ref_sel,
// splitmv, coeffs, nonzero, then the six quantizer factors.
extern "C" int inter_residues_launch(const long long* p, int R, int C,
                                     void* stream, int* n_launched) {
  ResidueArgs a;
  for (int k = 0; k < 3; ++k) {
    a.orig[k] = (const uint8_t*)p[k];
    a.pred[k] = (const uint8_t*)p[3 + k];
    a.pred_mb[k] = p[6 + k];
    a.recon[k] = (uint8_t*)p[9 + k];
  }
  a.ref_sel = (const int*)p[12];
  a.splitmv = (const uint8_t*)p[13];
  a.coeffs = (int16_t*)p[14];
  a.nonzero = (uint8_t*)p[15];
  for (int i = 0; i < 6; ++i) a.q[i] = (int)p[16 + i];
  a.R = R;
  a.C = C;
  *n_launched = 0;
  if (R * C == 0) return 0;
  inter_residues_kernel<<<R * C, RES_THREADS, 0, (cudaStream_t)stream>>>(a);
  *n_launched = 1;
  return (int)cudaGetLastError();
}
