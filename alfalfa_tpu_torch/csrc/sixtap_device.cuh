// The VP8 six-tap sub-pel filter of the interframe encoder's prediction
// and decision chain (enc_inter.cu: K8, enc_decide.cu: K9; the decoders'
// motion compensation, sixtap_mc.cu, has its own form of the passes).
// Each pass is a six-tap sum rounded with (acc + 64) >> 7 and clipped to
// [0, 255]; phase 0 is the identity tap 128, so both passes always run.
// Reads outside a plane clamp per index to its edge (what the reference's
// edge extension amounts to).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "intra_device.cuh"  // clampi

__constant__ int c_taps[8][6] = {
    {0, 0, 128, 0, 0, 0},      {0, -6, 123, 12, -1, 0},
    {2, -11, 108, 36, -8, 1},  {0, -9, 93, 50, -6, 0},
    {3, -16, 77, 77, -16, 3},  {0, -6, 50, 93, -9, 0},
    {1, -8, 36, 108, -11, 2},  {0, -1, 12, 123, -6, 0}};

__device__ __forceinline__ int round_clip(int acc) {
  return clampi((acc + 64) >> 7, 0, 255);
}

// One pass of phase f over p[0], p[step], ..., p[5 * step].
template <typename P>
__device__ __forceinline__ int sixtap(const P* p, int step, int f) {
  int acc = 0;
#pragma unroll
  for (int k = 0; k < 6; ++k) acc += (int)p[k * step] * c_taps[f][k];
  return round_clip(acc);
}

// The prediction of pixel (y, x) of an H x W plane at the eighth-pel
// vector (mvx, mvy), straight from the plane: six horizontal passes over
// rows y + (mvy >> 3) - 2 .. + 3, then the vertical one.
__device__ __forceinline__ int sixtap_pixel(const uint8_t* __restrict__ ref,
                                            int H, int W, int y, int x,
                                            int mvx, int mvy) {
  const int fx = mvx & 7, fy = mvy & 7;
  const int y0 = y + (mvy >> 3) - 2, x0 = x + (mvx >> 3) - 2;
  int cols[6], h[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) cols[k] = clampi(x0 + k, 0, W - 1);
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const uint8_t* row = ref + (size_t)clampi(y0 + k, 0, H - 1) * W;
    int win[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) win[j] = row[cols[j]];
    h[k] = sixtap(win, 1, fx);
  }
  return sixtap(h, 1, fy);
}
