// H1: the encoder's 4x4 transforms as device helpers, one block per call
// in one thread's registers: forward DCT and WHT, truncating quantization,
// and the decoder's dequantization, inverse WHT and inverse DCT that the
// encoder reconstructs with.  Shared by the encode kernels (enc_intra.cu,
// enc_inter.cu).  Blocks are 16 ints in raster order.
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
