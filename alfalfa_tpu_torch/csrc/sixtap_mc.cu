// mc_planes: VP8 six-tap sub-pel motion compensation of the three planes
// of G frames in one launch.
//
// Replaces the TPU kernels alfalfa_tpu/ops/sixtap_pallas.py:mc_tiles_packed
// (K2, the GOP decoder) and mc_tiles (K3, the single-frame decoder), each
// called there once per plane.  Kept from them: the semantics.  Per 4x4
// block the source window starts at (by + (mvy >> 3) - 2, bx + (mvx >> 3)
// - 2), the phases are mv & 7, the horizontal pass runs over the block's 9
// source rows, each pass rounds with (acc + 64) >> 7 and clips to
// [0, 255]; phase 0 is the identity tap 128, whose pass returns its input
// unchanged.  Not kept: the padded, byte-packed, 8/128-aligned reference
// copy and the rotate that undoes the alignment.  Edge extension is
// clamping to the plane, per row and, at the plane's left and right edges
// only, per column: no second copy of the references.
//
// Interface: each plane's three reference slots (last, golden, alternate)
// come as separate frames with a batch stride each, so the GOP decoder
// hands over views of its (G, 3, H, W) stacks, the single-frame decoder
// its three rasters' planes, and the fast encoder LAST once for all Q
// quantizers (stride 0), with no stacked copy; the vectors come with a
// macroblock and a 4x4-block stride, so one vector a macroblock goes in as
// an expanded view.
//
// Design: a thread computes one 4x4 block, four runs of 4 pixels, each
// stored as one 32-bit word; a macroblock is 24 threads (16 luma blocks,
// 4 U, 4 V), a block of 192 threads 8 macroblocks, the three planes in one
// grid.  A source row is two 64-bit loads where its window lies inside
// the plane (per-byte clamped loads only at the left and right edges),
// aligned with funnel shifts; each pass is two dp4a a pixel against the
// phase's taps packed as bytes, which each block keeps in shared memory,
// filled once; the vertical pass reads the 9 filtered rows as columns
// after a byte transpose.  Phase 0 skips its pass.  No thread reads
// another's pixels: no barrier but the one after the taps.
//
// Bound: memory.  Per call it must read the vectors and the selectors,
// read each referenced pixel once (about the planes, 384 bytes a
// macroblock) and write 384 prediction bytes a macroblock; arithmetic is
// 2 x 6 multiply-adds a pixel.  Windows of neighbouring blocks overlap,
// so the references are re-read from L1 and L2, not from device memory.
//
// Output is uint8 (the TPU kernels returned int32), each macroblock's
// three tiles side by side in one buffer (one allocation a call; the
// wrapper hands out a strided view a plane); the caller adds the residual
// in int16.  Macroblocks with ref_sel == 0 (intra) are predicted
// from slot 0 like any other; the caller masks them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "intra_device.cuh"  // clampi

// The output holds each macroblock's three tiles together: luma (256
// bytes), U (64), V (64).
#define MC_TILES 384

struct McArgs {
  const uint8_t* ref[3][3];    // [plane][slot]: frame 0 of each slot
  long long bstride[3][3];     // bytes from frame g to g + 1 (0: shared)
  uint8_t* out[3];             // each plane's first (S,S) prediction tile, the
                               // tiles interleaved MC_TILES bytes a macroblock
  const int* sel;              // (G,R,C) 0 intra, 1-3 the slot + 1; null: 1
  const int* mv[2];            // luma, chroma: (x, y) int32 pairs
  long long mv_mb[2], mv_blk[2];  // their macroblock and 4x4-block strides
  int G, R, C;
};

// The taps of phases 1-7 as signed bytes: taps 0-3 in one word, 4-5 in
// the low half of another (phase 0 never reaches them).
__device__ __forceinline__ uint32_t packed_taps(int k) {
  const uint32_t t[16] = {0u, 0u, 0x0c7bfa00u, 0xffu, 0x246cf502u, 0x1f8u,
                          0x325df700u, 0xfau, 0x4d4df003u, 0x3f0u,
                          0x5d32fa00u, 0xf7u, 0x6c24f801u, 0x2f5u,
                          0x7b0cff00u, 0xfau};
  uint32_t v = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) v = k == i ? t[i] : v;
  return v;
}

// acc + sum of the 4 unsigned bytes of ``a`` times the 4 signed bytes of
// ``b``.
__device__ __forceinline__ int dp4a_us(uint32_t a, uint32_t b, int acc) {
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(acc));
  return d;
}

// One six-tap output: the window's first 4 pixels in ``lo``, the next 2
// in the low half of ``hi``; the phase's taps ``ta``, ``tb``.
__device__ __forceinline__ uint32_t tap6(uint32_t lo, uint32_t hi,
                                         uint32_t ta, uint32_t tb) {
  return (uint32_t)clampi(dp4a_us(lo, ta, dp4a_us(hi, tb, 64)) >> 7, 0, 255);
}

__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return a | b << 8 | c << 16 | d << 24;
}

// The horizontal pass of one source row: pixels ``xs`` .. xs + 8 of row
// ``ys`` (both clamped to the H x W plane) filtered at phase ``fx`` into
// the 4 pixels of a block row, a byte each.
__device__ __forceinline__ uint32_t h_row(const uint8_t* ref, int H, int W,
                                          int ys, int xs, int fx,
                                          const uint32_t* taps) {
  const uint8_t* p = ref + (size_t)clampi(ys, 0, H - 1) * W;
  uint32_t u0, u1, u2;  // pixels xs .. xs + 11, 4 a word
  const int a8 = xs & ~7;
  if (a8 >= 0 && a8 + 16 <= W) {
    const uint2 lo = __ldg(reinterpret_cast<const uint2*>(p + a8));
    const uint2 hi = __ldg(reinterpret_cast<const uint2*>(p + a8 + 8));
    const bool up = (xs - a8) & 4;
    const uint32_t w0 = up ? lo.y : lo.x, w1 = up ? hi.x : lo.y;
    const uint32_t w2 = up ? hi.y : hi.x, w3 = hi.y;
    const int sh = ((xs - a8) & 3) * 8;
    u0 = __funnelshift_r(w0, w1, sh);
    u1 = __funnelshift_r(w1, w2, sh);
    u2 = __funnelshift_r(w2, w3, sh);
  } else {
    uint32_t b[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) b[k] = __ldg(p + clampi(xs + k, 0, W - 1));
    u0 = pack4(b[0], b[1], b[2], b[3]);
    u1 = pack4(b[4], b[5], b[6], b[7]);
    u2 = b[8];
  }
  if (fx == 0) return __funnelshift_r(u0, u1, 16);
  const uint32_t ta = taps[2 * fx], tb = taps[2 * fx + 1];
  return pack4(tap6(u0, u1, ta, tb),
               tap6(__funnelshift_r(u0, u1, 8), __funnelshift_r(u1, u2, 8), ta, tb),
               tap6(__funnelshift_r(u0, u1, 16), __funnelshift_r(u1, u2, 16), ta, tb),
               tap6(__funnelshift_r(u0, u1, 24), __funnelshift_r(u1, u2, 24), ta, tb));
}

// The vertical pass of a 4x4 block: its 9 filtered rows ``h`` (4 pixels
// a word) at phase ``fy`` (not 0) into its 4 output rows, 4 pixels a word.
// The rows are turned into columns (9 bytes a column in 3 words) with
// byte permutes, and each output pixel takes its column's 6 bytes with
// two funnel shifts.
__device__ __forceinline__ void v_pass(uint32_t (&o)[4], const uint32_t (&h)[9],
                                       int fy, const uint32_t* taps) {
  const uint32_t ta = taps[2 * fy], tb = taps[2 * fy + 1];
  uint32_t col[4][3];  // column c: rows 0-3, rows 4-7, row 8 (low byte)
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const uint32_t p01 = __byte_perm(h[4 * q], h[4 * q + 1], 0x5140);
    const uint32_t p23 = __byte_perm(h[4 * q + 2], h[4 * q + 3], 0x5140);
    const uint32_t q01 = __byte_perm(h[4 * q], h[4 * q + 1], 0x7362);
    const uint32_t q23 = __byte_perm(h[4 * q + 2], h[4 * q + 3], 0x7362);
    col[0][q] = __byte_perm(p01, p23, 0x5410);
    col[1][q] = __byte_perm(p01, p23, 0x7632);
    col[2][q] = __byte_perm(q01, q23, 0x5410);
    col[3][q] = __byte_perm(q01, q23, 0x7632);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) col[c][2] = h[8] >> (8 * c);
  uint32_t px[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      px[i][c] = tap6(__funnelshift_r(col[c][0], col[c][1], 8 * i),
                      __funnelshift_r(col[c][1], col[c][2], 8 * i), ta, tb);
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = pack4(px[i][0], px[i][1], px[i][2], px[i][3]);
}

#define MC_THREADS 192  // 8 macroblocks of 24 blocks

// grid (ceil(R * C * 24 / MC_THREADS), G): thread t of frame g is block
// t % 24 of macroblock t / 24 (raster order): 0-15 its luma blocks, 16-19
// its U blocks, 20-23 its V blocks (each in raster order).
__global__ void __launch_bounds__(MC_THREADS) mc_planes_kernel(McArgs a) {
  __shared__ uint32_t s_taps[16];
  if (threadIdx.x < 16) s_taps[threadIdx.x] = packed_taps(threadIdx.x);
  __syncthreads();
  const int R = a.R, C = a.C, g = blockIdx.y;
  const int t = blockIdx.x * MC_THREADS + threadIdx.x;
  if (t >= R * C * 24) return;
  const int m = t / 24, u = t - m * 24;
  const int r = m / C, c = m - r * C;
  const bool luma = u < 16;
  const int pl = luma ? 0 : 1 + ((u - 16) >> 2);
  const int b = luma ? u : u & 3;  // the block, raster order
  const int S = luma ? 16 : 8;
  const int by = (luma ? b >> 2 : b >> 1) * 4, bx = (luma ? b & 3 : b & 1) * 4;
  const size_t mb = (size_t)g * R * C + m;
  const int slot = a.sel ? clampi(a.sel[mb] - 1, 0, 2) : 0;
  // the argument arrays indexed with constants only (a computed index
  // would copy them to local memory)
  const uint8_t* ref = a.ref[0][0];
  long long bstride = a.bstride[0][0];
#pragma unroll
  for (int q = 1; q < 9; ++q)
    if (q == pl * 3 + slot) {
      ref = a.ref[q / 3][q % 3];
      bstride = a.bstride[q / 3][q % 3];
    }
  ref += g * bstride;
  const int* mv = luma ? a.mv[0] + mb * a.mv_mb[0] + b * a.mv_blk[0]
                       : a.mv[1] + mb * a.mv_mb[1] + b * a.mv_blk[1];
  uint8_t* out = pl == 0 ? a.out[0] : pl == 1 ? a.out[1] : a.out[2];
  const int mvx = mv[0], mvy = mv[1];
  const int H = R * S, W = C * S;
  const int ys = r * S + by + (mvy >> 3) - 2;   // the block's first source row
  const int xs = c * S + bx + (mvx >> 3) - 2;   // and column
  const int fx = mvx & 7, fy = mvy & 7;
  uint32_t o[4];
  if (fy == 0) {  // the vertical pass is the identity: rows 2-5 alone
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = h_row(ref, H, W, ys + 2 + i, xs, fx, s_taps);
  } else {
    uint32_t h[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) h[j] = h_row(ref, H, W, ys + j, xs, fx, s_taps);
    v_pass(o, h, fy, s_taps);
  }
  uint8_t* dst = out + mb * MC_TILES + by * S + bx;
#pragma unroll
  for (int i = 0; i < 4; ++i) *reinterpret_cast<uint32_t*>(dst + i * S) = o[i];
}

// p: 28 words, the McArgs fields in order (ref[3][3], bstride[3][3],
// out[3], sel, mv[2], mv_mb[2], mv_blk[2] interleaved as y mb, y blk,
// chroma mb, chroma blk).  Returns cudaGetLastError() after the launch and
// writes the number of kernel launches it issued to ``*n_launched``.
extern "C" int mc_planes_launch(const long long* p, int G, int R, int C,
                                void* stream, int* n_launched) {
  McArgs a;
  for (int k = 0; k < 9; ++k) {
    a.ref[k / 3][k % 3] = (const uint8_t*)p[k];
    a.bstride[k / 3][k % 3] = p[9 + k];
  }
  for (int k = 0; k < 3; ++k) a.out[k] = (uint8_t*)p[18 + k];
  a.sel = (const int*)p[21];
  a.mv[0] = (const int*)p[22];
  a.mv[1] = (const int*)p[23];
  a.mv_mb[0] = p[24]; a.mv_blk[0] = p[25];
  a.mv_mb[1] = p[26]; a.mv_blk[1] = p[27];
  a.G = G; a.R = R; a.C = C;
  const int threads = R * C * 24;
  mc_planes_kernel<<<dim3((threads + MC_THREADS - 1) / MC_THREADS, G),
                     MC_THREADS, 0, (cudaStream_t)stream>>>(a);
  *n_launched = 1;
  return (int)cudaGetLastError();
}
