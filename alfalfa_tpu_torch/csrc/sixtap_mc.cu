// sixtap_mc: VP8 six-tap sub-pel motion compensation, one plane of G frames.
//
// Replaces the TPU kernel alfalfa_tpu/ops/sixtap_pallas.py:mc_tiles_packed
// (and its unpacked twin mc_tiles).  Kept from it: the semantics.  Per 4x4
// block the source window starts at (by + (mvy >> 3) - 2, bx + (mvx >> 3) - 2),
// the phases are mv & 7, the horizontal pass runs over S+5 rows, each pass
// rounds with (acc + 64) >> 7 and clips to [0, 255], and both passes always
// run (phase 0 is the identity tap 128).  Not kept: the padded, byte-packed,
// 8/128-aligned reference copy and the rotate that undoes the alignment.
// Edge extension here is per-index clamping to the plane, which needs no
// second copy of the references.
//
// Design: one thread block per macroblock (grid C x R x G), one thread per
// output pixel (S*S threads); the filter's passes are sixtap_device.cuh's,
// shared with the interframe encoder (enc_inter.cu).  A macroblock whose sub-MVs are all equal
// stages one (S+5)x(S+5) window in shared memory; a SPLITMV macroblock
// stages one 9x9 window per 4x4 block.  Both cases run the same two passes.
//
// Bound: memory.  Per call it must read G*R*C*(S/4)^2*2 int32 motion vectors
// and G*R*C int32 selectors, read each referenced pixel once (about one plane,
// G*H*W bytes) and write G*H*W prediction bytes; arithmetic is 12 multiply-adds
// per pixel.  Windows of neighbouring macroblocks overlap, so the references
// are re-read from L2, not from device memory.
//
// Output is uint8 (the TPU kernel returned int32); the caller adds the
// residual in int16.  Macroblocks with ref_sel == 0 (intra) are predicted
// from slot 0 like any other; the caller masks them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sixtap_device.cuh"  // the filter: c_taps, sixtap, clampi

template <int S>
__global__ void sixtap_mc_kernel(const uint8_t* __restrict__ refs,
                                 const int* __restrict__ ref_sel,
                                 const int* __restrict__ sub_mv,
                                 uint8_t* __restrict__ out,
                                 int R, int C, int H, int W) {
  constexpr int N = S / 4;
  constexpr int NB = N * N;
  constexpr int WIN = S + 5;
  constexpr int T = S * S;
  static_assert(NB * 81 >= WIN * WIN, "window buffer sized for the split case");
  static_assert(NB * 36 >= WIN * S, "mid buffer sized for the split case");
  __shared__ uint8_t s_win[NB * 81];
  __shared__ uint8_t s_mid[NB * 36];

  const int c = blockIdx.x, r = blockIdx.y, g = blockIdx.z;
  const int mb = (g * R + r) * C + c;
  const int tid = threadIdx.x;
  const int py = tid / S, px = tid % S;
  const int bi = (py >> 2) * N + (px >> 2);
  const int* mvp = sub_mv + (size_t)mb * NB * 2;
  const int mvx = mvp[bi * 2], mvy = mvp[bi * 2 + 1];
  const int mv0x = mvp[0], mv0y = mvp[1];
  const int split = __syncthreads_or((mvx != mv0x) | (mvy != mv0y));

  const int slot = clampi(ref_sel[mb] - 1, 0, 2);
  const uint8_t* ref = refs + (size_t)(g * 3 + slot) * H * W;
  int out_px;

  if (!split) {
    const int y0 = r * S + (mv0y >> 3) - 2;
    const int x0 = c * S + (mv0x >> 3) - 2;
    for (int i = tid; i < WIN * WIN; i += T) {
      const int wy = i / WIN, wx = i % WIN;
      s_win[i] = ref[(size_t)clampi(y0 + wy, 0, H - 1) * W
                     + clampi(x0 + wx, 0, W - 1)];
    }
    __syncthreads();
    const int fx = mv0x & 7, fy = mv0y & 7;
    for (int i = tid; i < WIN * S; i += T) {
      const int wy = i / S, wx = i % S;
      s_mid[i] = (uint8_t)sixtap(s_win + wy * WIN + wx, 1, fx);
    }
    __syncthreads();
    out_px = sixtap(s_mid + py * S + px, S, fy);
  } else {
    for (int i = tid; i < NB * 81; i += T) {
      const int b = i / 81, k = i % 81;
      const int wy = k / 9, wx = k % 9;
      const int y0 = r * S + (b / N) * 4 + (mvp[b * 2 + 1] >> 3) - 2;
      const int x0 = c * S + (b % N) * 4 + (mvp[b * 2] >> 3) - 2;
      s_win[i] = ref[(size_t)clampi(y0 + wy, 0, H - 1) * W
                     + clampi(x0 + wx, 0, W - 1)];
    }
    __syncthreads();
    for (int i = tid; i < NB * 36; i += T) {
      const int b = i / 36, k = i % 36;
      const int wy = k / 4, wx = k % 4;
      const int fx = mvp[b * 2] & 7;
      s_mid[i] = (uint8_t)sixtap(s_win + b * 81 + wy * 9 + wx, 1, fx);
    }
    __syncthreads();
    const int ly = py & 3, lx = px & 3, fy = mvy & 7;
    out_px = sixtap(s_mid + bi * 36 + ly * 4 + lx, 4, fy);
  }
  out[(size_t)mb * T + tid] = (uint8_t)out_px;
}

// refs (G,3,H,W) u8; ref_sel (G,R,C) i32; sub_mv (G,R,C,S/4,S/4,2) i32;
// out (G,R,C,S,S) u8.  Returns cudaGetLastError() after the launch, or -1
// for an unsupported S, and writes the number of kernel launches it issued
// to ``*n_launched``.
extern "C" int sixtap_mc_launch(const void* refs, const void* ref_sel,
                                const void* sub_mv, void* out, int G, int R,
                                int C, int H, int W, int S, void* stream,
                                int* n_launched) {
  *n_launched = 0;
  dim3 grid(C, R, G);
  cudaStream_t st = (cudaStream_t)stream;
  if (S == 16) {
    sixtap_mc_kernel<16><<<grid, 256, 0, st>>>(
        (const uint8_t*)refs, (const int*)ref_sel, (const int*)sub_mv,
        (uint8_t*)out, R, C, H, W);
  } else if (S == 8) {
    sixtap_mc_kernel<8><<<grid, 64, 0, st>>>(
        (const uint8_t*)refs, (const int*)ref_sel, (const int*)sub_mv,
        (uint8_t*)out, R, C, H, W);
  } else {
    return -1;
  }
  *n_launched = 1;
  return (int)cudaGetLastError();
}
