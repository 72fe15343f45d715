// H1: the encoder's 4x4 transforms as device helpers: forward DCT and WHT,
// truncating quantization, and the decoder's dequantization, inverse WHT
// and inverse DCT that the encoder reconstructs with.  Shared by the encode
// kernels (enc_intra.cu, enc_inter.cu, enc_intra_fixup.cu).  Two forms: one
// block per call in one thread's registers (blocks are 16 ints in raster
// order), and lane-parallel forms for the B_PRED chain (enc_mb_device.cuh),
// where lane p of each 16-lane half of a warp holds raster position p and
// a row or column pass gathers its four inputs with shuffles.
//
// Replaces alfalfa_tpu/ops/enc_transforms_pallas.py (fdct:37, idct:72,
// fwht:117, iwht:159, quantize:195, dequantize:211), which runs every
// block of a macroblock at once across the TPU's lanes with lane rolls and
// masks; here a thread owns a block and the rows and columns are plain
// indices.  Bit-exact to the reference (dct.cc:45-163, transform.cc:47-137,
// quantization.cc:95-157; the plain versions are ops/enc_transforms.py and
// ops/transforms.py): intermediates the reference stores as int16 wrap to
// int16 (w16), ``>>`` of a negative int is arithmetic, and quantization
// divides |c| and restores the sign (truncation toward zero).  Every
// product stays inside int32 because its operand was wrapped first.

#pragma once

#include <stdint.h>

__device__ __forceinline__ int w16(int x) { return (int)(int16_t)x; }

// Forward DCT of the residual d (vp8_short_fdct4x4).
__device__ __forceinline__ void fdct4x4(const int* d, int* out) {
  int t[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int* x = d + 4 * i;
    const int a1 = (x[0] + x[3]) * 8, b1 = (x[1] + x[2]) * 8;
    const int c1 = (x[1] - x[2]) * 8, d1 = (x[0] - x[3]) * 8;
    t[4 * i + 0] = w16(a1 + b1);
    t[4 * i + 1] = w16((c1 * 2217 + d1 * 5352 + 14500) >> 12);
    t[4 * i + 2] = w16(a1 - b1);
    t[4 * i + 3] = w16((d1 * 2217 - c1 * 5352 + 7500) >> 12);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int a1 = t[j] + t[12 + j], b1 = t[4 + j] + t[8 + j];
    const int c1 = t[4 + j] - t[8 + j], d1 = t[j] - t[12 + j];
    out[j] = w16((a1 + b1 + 7) >> 4);
    out[4 + j] = w16(((c1 * 2217 + d1 * 5352 + 12000) >> 16) + (d1 != 0));
    out[8 + j] = w16((a1 - b1 + 7) >> 4);
    out[12 + j] = w16((d1 * 2217 - c1 * 5352 + 51000) >> 16);
  }
}

// Forward Walsh-Hadamard of the 16 luma DCs (raster order) into Y2.
__device__ __forceinline__ void fwht4x4(const int* in, int* out) {
  int t[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int* x = in + 4 * i;
    const int a1 = (x[0] + x[2]) * 4, d1 = (x[1] + x[3]) * 4;
    const int c1 = (x[1] - x[3]) * 4, b1 = (x[0] - x[2]) * 4;
    t[4 * i + 0] = w16(a1 + d1 + (a1 != 0));
    t[4 * i + 1] = w16(b1 + c1);
    t[4 * i + 2] = w16(b1 - c1);
    t[4 * i + 3] = w16(a1 - d1);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int a1 = t[j] + t[8 + j], d1 = t[4 + j] + t[12 + j];
    const int c1 = t[4 + j] - t[12 + j], b1 = t[j] - t[8 + j];
    int v[4] = {a1 + d1, b1 + c1, b1 - c1, a1 - d1};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] += v[k] < 0;
      out[4 * k + j] = w16((v[k] + 3) >> 3);
    }
  }
}

// Truncating quantization: DC factor at position 0, AC elsewhere.
__device__ __forceinline__ void quantize4x4(const int* c, int dcf, int acf,
                                            int* out) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int f = i ? acf : dcf;
    const int q = (c[i] < 0 ? -c[i] : c[i]) / f;
    out[i] = c[i] < 0 ? -q : q;
  }
}

// Dequantization, wrapped to int16 like the reference's storage.
__device__ __forceinline__ void dequantize4x4(const int* c, int dcf, int acf,
                                              int* out) {
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = w16(c[i] * (i ? acf : dcf));
}

__device__ __forceinline__ int mul20091(int a) { return ((a * 20091) >> 16) + a; }
__device__ __forceinline__ int mul35468(int a) { return (a * 35468) >> 16; }

// Inverse DCT: dequantized coefficients -> the residual added to the
// prediction before clamping (out[4 * row + col]).
__device__ __forceinline__ void idct4x4(const int* c, int* out) {
  int t[16];  // t[4 * col + k]: pass 1 over each input column, stored int16
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int t0 = c[j] + c[8 + j], t1 = c[j] - c[8 + j];
    const int t2 = mul35468(c[4 + j]) - mul20091(c[12 + j]);
    const int t3 = mul20091(c[4 + j]) + mul35468(c[12 + j]);
    t[4 * j + 0] = w16(t0 + t3);
    t[4 * j + 1] = w16(t1 + t2);
    t[4 * j + 2] = w16(t1 - t2);
    t[4 * j + 3] = w16(t0 - t3);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int t0 = t[k] + t[8 + k], t1 = t[k] - t[8 + k];
    const int t2 = mul35468(t[4 + k]) - mul20091(t[12 + k]);
    const int t3 = mul20091(t[4 + k]) + mul35468(t[12 + k]);
    out[4 * k + 0] = (t0 + t3 + 4) >> 3;
    out[4 * k + 1] = (t1 + t2 + 4) >> 3;
    out[4 * k + 2] = (t1 - t2 + 4) >> 3;
    out[4 * k + 3] = (t0 - t3 + 4) >> 3;
  }
}

// Inverse Walsh-Hadamard: dequantized Y2 -> the 16 luma DCs (raster).
__device__ __forceinline__ void iwht4x4(const int* c, int* out) {
  int t[16];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int a1 = c[j] + c[12 + j], b1 = c[4 + j] + c[8 + j];
    const int c1 = c[4 + j] - c[8 + j], d1 = c[j] - c[12 + j];
    t[j] = w16(a1 + b1);
    t[4 + j] = w16(c1 + d1);
    t[8 + j] = w16(a1 - b1);
    t[12 + j] = w16(d1 - c1);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int* x = t + 4 * i;
    const int a1 = x[0] + x[3], b1 = x[1] + x[2];
    const int c1 = x[1] - x[2], d1 = x[0] - x[3];
    out[4 * i + 0] = w16((a1 + b1 + 3) >> 3);
    out[4 * i + 1] = w16((c1 + d1 + 3) >> 3);
    out[4 * i + 2] = w16((a1 - b1 + 3) >> 3);
    out[4 * i + 3] = w16((d1 - c1 + 3) >> 3);
  }
}

// ---- lane-parallel forms: every lane of the warp calls them; lane p of
// each 16-lane half holds the block's value at raster position p & 15

__device__ __forceinline__ int shfl16(int v, int src) {
  return __shfl_sync(0xffffffffu, v, src, 16);
}

// fdct4x4: the residual at this lane's position -> its coefficient.
__device__ __forceinline__ int fdct4x4_lane(int d, int p) {
  const int i = p >> 2, j = p & 3;
  // row pass: this lane computes t[4i + j] from row i
  const int x0 = shfl16(d, 4 * i), x1 = shfl16(d, 4 * i + 1);
  const int x2 = shfl16(d, 4 * i + 2), x3 = shfl16(d, 4 * i + 3);
  int a1 = (x0 + x3) * 8, b1 = (x1 + x2) * 8;
  int c1 = (x1 - x2) * 8, d1 = (x0 - x3) * 8;
  const int t = j == 0 ? w16(a1 + b1)
                : j == 1 ? w16((c1 * 2217 + d1 * 5352 + 14500) >> 12)
                : j == 2 ? w16(a1 - b1)
                         : w16((d1 * 2217 - c1 * 5352 + 7500) >> 12);
  // column pass: out[4i + j] from column j
  const int t0 = shfl16(t, j), t1 = shfl16(t, 4 + j);
  const int t2 = shfl16(t, 8 + j), t3 = shfl16(t, 12 + j);
  a1 = t0 + t3; b1 = t1 + t2; c1 = t1 - t2; d1 = t0 - t3;
  return i == 0 ? w16((a1 + b1 + 7) >> 4)
         : i == 1 ? w16(((c1 * 2217 + d1 * 5352 + 12000) >> 16) + (d1 != 0))
         : i == 2 ? w16((a1 - b1 + 7) >> 4)
                  : w16((d1 * 2217 - c1 * 5352 + 51000) >> 16);
}

// quantize4x4 / dequantize4x4 at this lane's position (factor f: DC at
// position 0, AC elsewhere).  quantize_lane divides by a multiply with
// ``inv`` = quantize_inv(f): exact, since |c| < 2^16 and 4 <= f < 2^15
// (VP8's factors are at least 4), so the multiplier's error n * e / 2^32,
// e <= f, stays below 1 / f.
__device__ __forceinline__ unsigned quantize_inv(int f) {
  return 0xffffffffu / (unsigned)f + 1;
}
__device__ __forceinline__ int quantize_lane(int c, unsigned inv) {
  const int q = (int)__umulhi((unsigned)(c < 0 ? -c : c), inv);
  return c < 0 ? -q : q;
}
__device__ __forceinline__ int dequantize_lane(int c, int f) {
  return w16(c * f);
}

// idct4x4: the dequantized coefficient at this lane's position -> the
// residual there.
__device__ __forceinline__ int idct4x4_lane(int c, int p) {
  const int hi = p >> 2, lo = p & 3;
  // pass 1: this lane computes t[p] = t[4 * col + k] from input column hi
  const int c0 = shfl16(c, hi), c1 = shfl16(c, 4 + hi);
  const int c2 = shfl16(c, 8 + hi), c3 = shfl16(c, 12 + hi);
  int t0 = c0 + c2, t1 = c0 - c2;
  int t2 = mul35468(c1) - mul20091(c3), t3 = mul20091(c1) + mul35468(c3);
  const int t = lo == 0 ? w16(t0 + t3) : lo == 1 ? w16(t1 + t2)
                : lo == 2 ? w16(t1 - t2) : w16(t0 - t3);
  // pass 2: out[4k + m] from t[k], t[4 + k], t[8 + k], t[12 + k]
  const int u0 = shfl16(t, hi), u1 = shfl16(t, 4 + hi);
  const int u2 = shfl16(t, 8 + hi), u3 = shfl16(t, 12 + hi);
  t0 = u0 + u2; t1 = u0 - u2;
  t2 = mul35468(u1) - mul20091(u3); t3 = mul20091(u1) + mul35468(u3);
  return lo == 0 ? (t0 + t3 + 4) >> 3 : lo == 1 ? (t1 + t2 + 4) >> 3
         : lo == 2 ? (t1 - t2 + 4) >> 3 : (t0 - t3 + 4) >> 3;
}
