// Intra-prediction helpers shared by the decode kernels
// (wavefront_device.cuh) and the encode kernels (enc_mb_device.cuh, for
// enc_intra.cu and enc_inter.cu), with the clamp sixtap_device.cuh uses:
// one pixel of a 4x4 b-mode prediction from its 13 edge pixels, one pixel
// of a whole-block prediction, and the whole-block DC value with the VP8
// edge rules (reference prediction.cc:99-643).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
__device__ __forceinline__ int avg2(int x, int y) { return (x + y + 1) >> 1; }
__device__ __forceinline__ int avg3(int x, int y, int z) {
  return (x + 2 * y + z + 2) >> 2;
}

// ----------------------------------------------------------------- intra

// Cell maps of the four "diagonal" b-modes: kind << 4 | index, kind 2 =
// avg2 entry, 3 = avg3 entry, 1 = left[3].
__constant__ uint8_t c_vr[16] = {0x20, 0x21, 0x22, 0x23, 0x32, 0x33, 0x34, 0x35,
                                 0x31, 0x20, 0x21, 0x22, 0x30, 0x32, 0x33, 0x34};
__constant__ uint8_t c_vl[16] = {0x20, 0x21, 0x22, 0x23, 0x30, 0x31, 0x32, 0x33,
                                 0x21, 0x22, 0x23, 0x34, 0x31, 0x32, 0x33, 0x35};
__constant__ uint8_t c_hd[16] = {0x23, 0x33, 0x34, 0x35, 0x22, 0x32, 0x23, 0x33,
                                 0x21, 0x31, 0x22, 0x32, 0x20, 0x30, 0x21, 0x31};
__constant__ uint8_t c_hu[16] = {0x20, 0x30, 0x21, 0x31, 0x21, 0x31, 0x22, 0x32,
                                 0x22, 0x32, 0x10, 0x10, 0x10, 0x10, 0x10, 0x10};

// One pixel (ly, lx) of a 4x4 b-mode prediction.  E[0..3] = left column
// bottom-up (L3..L0), E[4] = above-left, E[5..12] = above row A0..A7
// (A4..A7 = above-right).
__device__ int bpred_pixel(int mode, const int* E, int ly, int lx) {
  const int* A = E + 5;
  const int cell = ly * 4 + lx;
  switch (clampi(mode, 0, 9)) {
    case 0:  // B_DC
      return (A[0] + A[1] + A[2] + A[3] + E[0] + E[1] + E[2] + E[3] + 4) >> 3;
    case 1:  // B_TM
      return clampi(E[3 - ly] + A[lx] - E[4], 0, 255);
    case 2:  // B_VE
      return avg3(E[4 + lx], E[5 + lx], E[6 + lx]);
    case 3:  // B_HE
      return avg3(E[4 - ly], E[3 - ly], E[ly < 3 ? 2 - ly : 0]);
    case 4: {  // B_LD
      const int i = lx + ly;
      return avg3(A[i], A[i + 1], A[i + 2 > 7 ? 7 : i + 2]);
    }
    case 5: {  // B_RD
      const int k = lx - ly + 3;
      return avg3(E[k], E[k + 1], E[k + 2]);
    }
    case 6: {  // B_VR
      const int t = c_vr[cell], k = t & 15;
      return (t >> 4) == 2 ? avg2(E[k + 4], E[k + 5])
                           : avg3(E[k + 1], E[k + 2], E[k + 3]);
    }
    case 7: {  // B_VL
      const int t = c_vl[cell], k = t & 15;
      return (t >> 4) == 2 ? avg2(A[k], A[k + 1]) : avg3(A[k], A[k + 1], A[k + 2]);
    }
    case 8: {  // B_HD
      const int t = c_hd[cell], k = t & 15;
      return (t >> 4) == 2 ? avg2(E[k], E[k + 1]) : avg3(E[k], E[k + 1], E[k + 2]);
    }
    default: {  // B_HU
      const int t = c_hu[cell], k = t & 15, kind = t >> 4;
      if (kind == 1) return E[0];
      // L(j) = E[3 - j]
      if (kind == 2) return avg2(E[3 - k], E[2 - k]);
      return avg3(E[3 - k], E[2 - k], E[k + 2 > 3 ? 0 : 1 - k]);
    }
  }
}

__device__ __forceinline__ int whole_pixel(int mode, int dc, int above, int left,
                                           int corner) {
  switch (clampi(mode, 0, 3)) {
    case 0: return dc;
    case 1: return above;
    case 2: return left;
    default: return clampi(left + above - corner, 0, 255);
  }
}

__device__ __forceinline__ int dc_value(int sa, int sl, bool hrow, bool hcol,
                                        int log2) {
  if (hrow && hcol) return (sa + sl + (1 << log2)) >> (log2 + 1);
  if (hrow) return (sa + (1 << (log2 - 1))) >> log2;
  if (hcol) return (sl + (1 << (log2 - 1))) >> log2;
  return 128;
}
