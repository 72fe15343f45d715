// Device code of the decode wavefront, shared by the three C entries of
// wavefront.cu: K1 wavefront_decode_launch (GOP batch: intra prediction and
// loop filter in one persistent walk), K4 intra_frame_launch (intra
// prediction alone, one persistent walk) and K5 loop_filter_launch (loop
// filter alone).  One copy of the math: wave_row_kernel (K1),
// intra_row_kernel (K4) and lf_row_kernel (K5) with their helpers; the two
// filter kernels share lf_filter_window, the two intra kernels the
// reconstruction step (intra_above_load, intra_mb_rows) and bpred_chain.
// wavefront.cu's header says what these kernels replace and how they are
// scheduled.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "intra_device.cuh"
#include "row_sched.cuh"

#define NP 12  // int16 words per macroblock in mbp
// mbp words: 0 ymode, 1 uvmode, 2 has_nonzero, 3 intra, 4 filter level
// (0 = do not filter), 5 interior limit, 6 mb edge limit, 7 sub-block edge
// limit, 8 hev threshold, 9 skip sub-block edges.
#define B_PRED 4

// ----------------------------------------------------------- loop filter

__device__ __forceinline__ int c8(int x) { return clampi(x, -128, 127); }
__device__ __forceinline__ int iabs(int x) { return x < 0 ? -x : x; }

// Filter one position of one edge: q[0..7*st] = p3 p2 p1 p0 q0 q1 q2 q3.
__device__ void filter_edge(int* q, int st, bool mb_edge, int limit, int blimit,
                            int thresh) {
  const int p3 = q[0], p2 = q[st], p1 = q[2 * st], p0 = q[3 * st];
  const int q0 = q[4 * st], q1 = q[5 * st], q2 = q[6 * st], q3 = q[7 * st];
  const bool over = iabs(p3 - p2) > limit || iabs(p2 - p1) > limit ||
                    iabs(p1 - p0) > limit || iabs(q1 - q0) > limit ||
                    iabs(q2 - q1) > limit || iabs(q3 - q2) > limit ||
                    iabs(p0 - q0) * 2 + (iabs(p1 - q1) >> 1) > blimit;
  if (over) return;  // mask false: every output equals its input
  const bool hev = iabs(p1 - p0) > thresh || iabs(q1 - q0) > thresh;
  int sp2 = p2 - 128, sp1 = p1 - 128, sp0 = p0 - 128;
  int sq0 = q0 - 128, sq1 = q1 - 128, sq2 = q2 - 128;
  if (mb_edge) {
    const int fv = c8(c8(sp1 - sq1) + 3 * (sq0 - sp0));
    const int f = hev ? fv : 0;
    const int f1 = c8(f + 4) >> 3, f2 = c8(f + 3) >> 3;
    sq0 = c8(sq0 - f1);
    sp0 = c8(sp0 + f2);
    const int w = hev ? 0 : fv;
    int u = c8((63 + w * 27) >> 7);
    sq0 = c8(sq0 - u); sp0 = c8(sp0 + u);
    u = c8((63 + w * 18) >> 7);
    sq1 = c8(sq1 - u); sp1 = c8(sp1 + u);
    u = c8((63 + w * 9) >> 7);
    sq2 = c8(sq2 - u); sp2 = c8(sp2 + u);
    q[st] = sp2 + 128;
    q[6 * st] = sq2 + 128;
  } else {
    int fv = hev ? c8(sp1 - sq1) : 0;
    fv = c8(fv + 3 * (sq0 - sp0));
    const int f1 = c8(fv + 4) >> 3, f2 = c8(fv + 3) >> 3;
    sq0 = c8(sq0 - f1);
    sp0 = c8(sp0 + f2);
    const int outer = hev ? 0 : (f1 + 1) >> 1;
    sp1 = c8(sp1 + outer);
    sq1 = c8(sq1 - outer);
  }
  q[2 * st] = sp1 + 128;
  q[3 * st] = sp0 + 128;
  q[4 * st] = sq0 + 128;
  q[5 * st] = sq1 + 128;
}

template <int S>
__device__ void lf_line(int* line, int st, bool do_mb, bool do_sb, int interior,
                        int mb_lim, int sb_lim, int hev_t) {
  if (do_mb) filter_edge(line, st, true, interior, mb_lim, hev_t);
  if (do_sb)
    for (int o = 4; o < S; o += 4)
      filter_edge(line + o * st, st, false, interior, sb_lim, hev_t);
}

// The filter of one macroblock's three windows (luma 20x20, U and V 12x12,
// each with its 4-pixel halo above and left), one warp: the vertical
// edges a lane per pixel row, then the horizontal edges a lane per pixel
// column (lanes 0-15 luma, 16-23 U, 24-31 V).  Pass order: left MB edge,
// interior vertical edges, top MB edge, interior horizontal edges.  K5 runs
// the two passes apart (``vertical``, ``horizontal``): the vertical one
// reads no pixel of the row above.
__device__ __forceinline__ void lf_filter_window(int* s_y, int* s_u, int* s_v,
                                                 int lane, bool do_left,
                                                 bool do_top, bool do_sb,
                                                 int interior, int mb_lim,
                                                 int sb_lim, int hev_t,
                                                 bool vertical = true,
                                                 bool horizontal = true) {
  // vertical edges: one lane per pixel row of the macroblock
  if (!vertical) {
  } else if (lane < 16)
    lf_line<16>(s_y + (4 + lane) * 20, 1, do_left, do_sb, interior, mb_lim,
                sb_lim, hev_t);
  else if (lane < 24)
    lf_line<8>(s_u + (4 + lane - 16) * 12, 1, do_left, do_sb, interior, mb_lim,
               sb_lim, hev_t);
  else
    lf_line<8>(s_v + (4 + lane - 24) * 12, 1, do_left, do_sb, interior, mb_lim,
               sb_lim, hev_t);
  __syncwarp();
  if (!horizontal) return;
  // horizontal edges: one lane per pixel column
  if (lane < 16)
    lf_line<16>(s_y + 4 + lane, 20, do_top, do_sb, interior, mb_lim, sb_lim,
                hev_t);
  else if (lane < 24)
    lf_line<8>(s_u + 4 + lane - 16, 12, do_top, do_sb, interior, mb_lim, sb_lim,
               hev_t);
  else
    lf_line<8>(s_v + 4 + lane - 24, 12, do_top, do_sb, interior, mb_lim, sb_lim,
               hev_t);
  __syncwarp();
}

// ------------------------------------ the row walkers' macroblock step

// Byte k of a row held four to a word.
__device__ __forceinline__ int row_byte(const uint32_t* w, int k) {
  return (w[k >> 2] >> (8 * (k & 3))) & 255;
}

// own[0..S-1] (S = 16 or 8 pixels) 4 a word.
__device__ __forceinline__ void pack_row(uint32_t (&u)[4], const int* own,
                                         int S) {
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (4 * w + k < S) v |= (uint32_t)own[4 * w + k] << (8 * k);
    u[w] = v;
  }
}

// A row of a macroblock's halo above (16 luma or 8 chroma pixels, 4 a
// word) from the filtered output at ``src``, through L2: the row above's
// walker wrote it during the launch.
__device__ __forceinline__ void lf_halo_load(uint32_t (&h)[4],
                                             const uint8_t* src, bool luma) {
  if (luma) {
    const uint4 v = __ldcg(reinterpret_cast<const uint4*>(src));
    h[0] = v.x; h[1] = v.y; h[2] = v.z; h[3] = v.w;
  } else {
    const uint2 v = __ldcg(reinterpret_cast<const uint2*>(src));
    h[0] = v.x; h[1] = v.y; h[2] = h[3] = 0;
  }
}

// The halo row ``h`` (``n`` pixels) into its window row ``dst``.
__device__ __forceinline__ void lf_halo_put(int* dst, const uint32_t (&h)[4],
                                            int n) {
#pragma unroll
  for (int k = 0; k < 16; ++k)
    if (k < n) dst[k] = row_byte(h, k);
}

// The end of a macroblock's filter step in lf_row_kernel and
// wave_row_kernel: this lane's window row ``own`` (``S`` pixels, 16 luma
// or 8 chroma) out at ``dst`` and, with ``do_left``, the left neighbour's
// last 3 pixels before it; with ``halo_out`` (the top edge filtered, lanes
// 1-3, 5-7 and 9-11) the halo row ``hsrc`` (``HS`` pixels) out at ``hd``,
// one of the last 3 rows of the macroblock above; then the macroblock's
// last 4 columns kept as the next one's left halo.
__device__ __forceinline__ void lf_mb_out(int* own, int S, bool luma,
                                          uint8_t* dst, bool do_left,
                                          bool halo_out, const int* hsrc,
                                          int HS, uint8_t* hd) {
  uint32_t px[4];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (4 * w + k < S) v |= (uint32_t)own[4 * w + k] << (8 * k);
    px[w] = v;
  }
  if (luma) *reinterpret_cast<uint4*>(dst) = make_uint4(px[0], px[1], px[2], px[3]);
  else *reinterpret_cast<uint2*>(dst) = make_uint2(px[0], px[1]);
  if (do_left)
    for (int k = 1; k < 4; ++k) dst[k - 4] = (uint8_t)own[k - 4];
  if (halo_out) {
    uint32_t h[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      uint32_t v = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * w + k < HS) v |= (uint32_t)hsrc[4 * w + k] << (8 * k);
      h[w] = v;
    }
    if (HS == 16) *reinterpret_cast<uint4*>(hd) = make_uint4(h[0], h[1], h[2], h[3]);
    else *reinterpret_cast<uint2*>(hd) = make_uint2(h[0], h[1]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) own[k - 4] = own[S - 4 + k];
}

// ------------------------------------------------- K5: the persistent form

struct LfRowArgs {
  uint8_t *Y, *U, *V;                 // filtered planes (G,16R,16C), (G,8R,8C)
  const uint8_t *y_in, *u_in, *v_in;  // unfiltered planes: frame g at
  size_t in_y, in_c;                  // g * in_y / in_c (0: one frame for all)
  const int16_t* mbp;                 // (G,R,C,NP), words 4-9
  int G, R, C;
  RowSched rs;                        // progress (G, R)
};

// One warp per (row, frame) ticket, the frame inner: the row's macroblocks
// left to right.  Lane ``lane`` owns one pixel row of the macroblock
// (lanes 0-15 luma rows, 16-23 U rows, 24-31 V rows) in the windows
// lf_filter_window filters.  A macroblock's own pixels come from the input
// (read before the wait: no one writes them during the launch), the
// 4-pixel halo above from the output (row r-1's, written during the
// launch: L2 loads after the acquire), the 4-pixel halo on the left from
// shared memory, where the previous macroblock left its right columns
// after its own filter.  The vertical edges run before the wait on row
// r-1 (the split wait), the horizontal ones after it; every output pixel is written by its macroblock
// (a copy where the level is 0), the 3 columns left and 3 rows above it by
// the filter of their edges.
__global__ void __launch_bounds__(32) lf_row_kernel(LfRowArgs a) {
  const int lane = threadIdx.x;
  __shared__ int s_y[20 * 20], s_u[12 * 12], s_v[12 * 12];
  __shared__ int s_ticket;
  if (lane == 0) s_ticket = atomicAdd(a.rs.ticket, 1);
  __syncwarp();
  const int G = a.G, R = a.R, C = a.C;
  const int r = s_ticket / G, g = s_ticket % G;
  const int W = C * 16, H = R * 16, Wc = W / 2, Hc = H / 2;
  const bool luma = lane < 16, is_u = lane >= 16 && lane < 24;
  const int S = luma ? 16 : 8, WS = S + 4, Wp = luma ? W : Wc;
  const int row = luma ? lane : lane & 7;
  int* win = luma ? s_y : is_u ? s_u : s_v;
  uint8_t* out = luma ? a.Y + (size_t)g * H * W
                      : (is_u ? a.U : a.V) + (size_t)g * Hc * Wc;
  const uint8_t* in = luma ? a.y_in + g * a.in_y
                           : (is_u ? a.u_in : a.v_in) + g * a.in_c;
  // the halo above: lanes 0-3 luma rows, 4-7 U rows, 8-11 V rows
  const int hp = lane >> 2, hrow = lane & 3, HS = hp ? 8 : 16;
  int* hwin = hp == 0 ? s_y : hp == 1 ? s_u : s_v;
  uint8_t* hplane = hp == 0 ? a.Y + (size_t)g * H * W
                    : (hp == 1 ? a.U : a.V) + (size_t)g * Hc * Wc;
  const int hW = hp ? Wc : W;
  int* prog = a.rs.progress + g * R + r;
  const int lag = a.rs.lag;
  const int y = r * S + row;             // this lane's plane row
  const int16_t* mbp = a.mbp + (size_t)(g * R + r) * C * NP;

  // the next macroblock's input row of this lane (4 pixels a word) and its
  // words 4-9 (two int16 a word), loaded a macroblock ahead
  uint32_t nx[4], nw[3];
  auto fetch = [&](int c) {
    const uint8_t* src = in + (size_t)y * Wp + c * S;
    if (luma) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
      nx[0] = v.x; nx[1] = v.y; nx[2] = v.z; nx[3] = v.w;
    } else {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
      nx[0] = v.x; nx[1] = v.y; nx[2] = nx[3] = 0;
    }
    const uint32_t* w = reinterpret_cast<const uint32_t*>(mbp + (size_t)c * NP + 4);
    nw[0] = __ldg(w); nw[1] = __ldg(w + 1); nw[2] = __ldg(w + 2);
  };
  fetch(0);
  for (int c = 0; c < C; ++c) {
    const int x0 = c * S;
    uint32_t px[4] = {nx[0], nx[1], nx[2], nx[3]};
    const uint32_t w0 = nw[0], w1 = nw[1], w2 = nw[2];
    if (c + 1 < C) fetch(c + 1);
    const int16_t p[6] = {(int16_t)w0, (int16_t)(w0 >> 16), (int16_t)w1,
                          (int16_t)(w1 >> 16), (int16_t)w2,
                          (int16_t)(w2 >> 16)};  // words 4-9
    const bool on = p[0] != 0;
    const bool do_left = on && c > 0, do_top = on && r > 0;
    int* own = win + (4 + row) * WS + 4;
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (k < S) own[k] = (px[k >> 2] >> (8 * (k & 3))) & 255;
    // the vertical edges (each lane its own row and the kept left halo)
    // before the wait: they read nothing of row r-1
    if (on)
      lf_filter_window(s_y, s_u, s_v, lane, do_left, do_top, p[5] == 0, p[1],
                       p[2], p[3], p[4], true, false);
    if (lane == 0 && r > 0) row_wait(prog - 1, min(c + lag, C));
    __syncwarp();
    int* hdst = hwin + hrow * (HS + 4) + 4;  // lanes 0-11: a halo row
    uint8_t* habove = hplane + (size_t)(r * HS - 4 + hrow) * hW + c * HS;
    if (do_top && lane < 12) {
      uint32_t h[4];
      lf_halo_load(h, habove, hp == 0);
      lf_halo_put(hdst, h, HS);
    }
    __syncwarp();
    if (on)
      lf_filter_window(s_y, s_u, s_v, lane, do_left, do_top, p[5] == 0, p[1],
                       p[2], p[3], p[4], false, true);
    lf_mb_out(own, S, luma, out + (size_t)y * Wp + x0, do_left,
              do_top && lane < 12 && hrow > 0, hdst, HS, habove);
    __syncwarp();                       // every output of (r, c) written
    if (lane == 0) row_publish(prog, c + 1);
  }
}

// ------------------------------------------------- K1: the persistent form

struct WaveRowArgs {
  uint8_t *Y, *U, *V;           // filtered planes (G,16R,16C), (G,8R,8C)
  uint8_t *ey, *eu, *ev;        // the unfiltered bottom pixel row of each
                                // macroblock: (G,R,16C), (G,R,8C)
  const uint8_t *ty, *tu, *tv;  // stage-B tiles (G,R,C,S,S)
  const int16_t *ry, *ru, *rv;  // residual tiles (G,R,C,S,S)
  const int16_t* mbp;           // (G,R,C,NP), words 0-9
  const uint8_t* bmode;         // (G,R,C,16)
  int G, R, C;
  RowSched rs;                  // progress (G, R)
};

// The 16 sub-blocks of a B_PRED macroblock on the warp, in 10 steps along
// the diagonals 2 sr + sc, two sub-blocks a step on the half-warps (a
// step with one: the second half repeats the first's without writing), as
// K7's B_PRED candidate (enc_mb_device.cuh) with the b-modes given: a
// sub-block reads its left, above, above-left and above-right neighbours,
// all on earlier diagonals.  ``t``: row 0 the macroblock's above-left,
// above x16 and above-right x4, column 0 its left, cell (1+y, 1+x) pixel
// (y, x), written here; ``res``: the luma residual, raster (added where
// ``nz``); ``bm``: the b-modes.
__device__ __forceinline__ void bpred_chain(int (&t)[17][21], int (&e)[2][13],
                                            const int16_t* res, bool nz,
                                            const int* bm, int lane) {
  const int h = lane >> 4, p = lane & 15, ly = p >> 2, lx = p & 3;
  for (int d = 0; d < 10; ++d) {
    // half h takes the (h+1)-th sub-block of diagonal d, in order of rows
    const int first = d < 3 ? 0 : (d - 2) >> 1;
    const bool active = first + h <= 3 && d - 2 * (first + h) >= 0;
    const int sr = active ? first + h : first, sc = d - 2 * sr;
    const int by = sr * 4, bx = sc * 4;
    // bpred_pixel's E: the left column bottom-up, above-left, above and
    // above-right; the right-most sub-block takes its above-right from
    // the row above the macroblock in every sub-block row
    int* E = e[h];
    if (p < 4) E[p] = t[by + 4 - p][bx];
    else if (p < 9) E[p] = t[by][bx + p - 4];
    else if (p < 13) E[p] = t[sc == 3 ? 0 : by][bx + p - 4];
    const int mode = bm[sr * 4 + sc];
    const int r = nz ? res[(by + ly) * 16 + bx + lx] : 0;
    __syncwarp();
    const int pred = bpred_pixel(mode, E, ly, lx);
    if (active) t[by + 1 + ly][bx + 1 + lx] = clampi(pred + r, 0, 255);
    __syncwarp();
  }
}

// ----------------------- the intra reconstruction step of K1 and K4

// The pixels above intra macroblock (r, c), r > 0, in this lane's plane,
// through L2 after the acquire (row r-1 wrote them during the launch):
// ``A`` the S above (4 a word), ``corner`` the above-left (129 in column
// 0) and, on lane 0 of a B_PRED macroblock, ``ar`` the 4 above-right (the
// last column repeats the above row's last pixel).  ``ab``: the row above
// the macroblock in this lane's plane, at the macroblock's first column.
__device__ __forceinline__ void intra_above_load(uint32_t (&A)[4], int& corner,
                                                 int& ar, const uint8_t* ab,
                                                 bool luma, bool bpred,
                                                 int lane, int c, int C) {
  if (luma) {
    const uint4 v = __ldcg(reinterpret_cast<const uint4*>(ab));
    A[0] = v.x; A[1] = v.y; A[2] = v.z; A[3] = v.w;
  } else {
    const uint2 v = __ldcg(reinterpret_cast<const uint2*>(ab));
    A[0] = v.x; A[1] = v.y;
  }
  corner = c > 0 ? __ldcg(ab - 1) : 129;
  if (bpred && lane == 0)
    ar = c == C - 1 ? 0x01010101 * (A[3] >> 24)
                    : __ldcg(reinterpret_cast<const int*>(ab + 16));
}

// The whole-block prediction of intra macroblock (r, c), one pixel row a
// lane (lanes 0-15 luma rows, 16-23 U, 24-31 V; ``row`` this lane's), with
// its residual ``res`` (luma raster, then U, V; this lane's row at
// ``res_at``) added where ``nz``, into own[0..S-1]: chroma always, luma
// unless ``bpred``, and only where ``rows``.  The DC comes from the row
// above (``A``, 4 a word) and the lanes' left pixels (``left``, 129 in
// column 0); the four modes computed and one selected (luma and chroma
// lanes take different modes).  For a B_PRED macroblock the luma lanes set
// up bpred_chain's tile ``t`` instead: its left column, on lane 0 its
// above-left (``corner``), above and above-right (``ar``) row, and
// ``s_bm[lane]`` = ``bm``; the caller then runs the chain.  Every lane of
// the warp calls it.
__device__ __forceinline__ void intra_mb_rows(
    int* own, bool luma, int row, int ymode, int uvmode, bool nz, bool bpred,
    int bm, const uint32_t (&A)[4], int corner, int ar, int left,
    bool hrow_mb, bool hcol, const int16_t* res, int res_at,
    int (&t)[17][21], int* s_bm, int lane, bool rows = true) {
  const int S = luma ? 16 : 8;
  int sa = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k)
    if (k < S) sa += row_byte(A, k);
  int sl = left;
  sl += __shfl_xor_sync(0xffffffffu, sl, 1);
  sl += __shfl_xor_sync(0xffffffffu, sl, 2);
  sl += __shfl_xor_sync(0xffffffffu, sl, 4);
  const int s8 = __shfl_xor_sync(0xffffffffu, sl, 8);
  if (luma) sl += s8;  // 16 luma rows; U and V 8 each
  const int dc = dc_value(sa, sl, hrow_mb, hcol, luma ? 4 : 3);
  if (!luma || !bpred) {
    if (rows) {
      const int mode = clampi(luma ? ymode : uvmode, 0, 3);
      const uint4 rv = *reinterpret_cast<const uint4*>(res + res_at);
      const uint4 rw = luma ? *reinterpret_cast<const uint4*>(res + res_at + 8)
                            : make_uint4(0, 0, 0, 0);
      const uint32_t rr[8] = {rv.x, rv.y, rv.z, rv.w, rw.x, rw.y, rw.z, rw.w};
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if (k < S) {
          const int above = row_byte(A, k);
          const int pred = mode == 0 ? dc : mode == 1 ? above
                           : mode == 2 ? left
                           : clampi(left + above - corner, 0, 255);
          const int rk = nz ? (int16_t)(rr[k >> 1] >> (16 * (k & 1))) : 0;
          own[k] = clampi(pred + rk, 0, 255);
        }
    }
  } else {
    t[1 + row][0] = left;
    s_bm[lane] = bm;
    if (lane == 0) {
      t[0][0] = corner;
#pragma unroll
      for (int k = 0; k < 16; ++k) t[0][1 + k] = row_byte(A, k);
#pragma unroll
      for (int k = 0; k < 4; ++k) t[0][17 + k] = (ar >> (8 * k)) & 255;
    }
  }
}

// One warp per (row, frame) ticket, the frame inner: the row's macroblocks
// left to right, each reconstructed and then filtered before the next.
// Lane ``lane`` owns one pixel row of the macroblock (lanes 0-15 luma
// rows, 16-23 U rows, 24-31 V rows), reconstructed into the windows
// lf_filter_window filters, as in lf_row_kernel.  An inter macroblock's
// rows are its stage-B tile (read a macroblock ahead); they are in place,
// and its vertical edges filtered, before the wait on row r-1.  An intra
// macroblock is predicted after the wait from unfiltered neighbours: the
// left column is the previous macroblock's last one, kept in a register
// per lane; the row above (with above-left and above-right) is row r-1's
// unfiltered bottom rows, written during the launch (L2 loads); its
// residual was copied into shared memory a macroblock ahead (cp.async).
// Each macroblock writes its own unfiltered bottom rows for row r+1.  The
// filter is lf_row_kernel's: the left halo kept in shared memory, the
// halo above from the output through L2.
__global__ void __launch_bounds__(32) wave_row_kernel(WaveRowArgs a) {
  const int lane = threadIdx.x;
  __shared__ int s_y[20 * 20], s_u[12 * 12], s_v[12 * 12];
  __shared__ int s_t[17][21];  // a B_PRED macroblock's working tile
  __shared__ int s_e[2][13];   // the edges of the half-warps' sub-blocks
  __shared__ int s_bm[16];     // its b-modes
  // the residual tiles (luma raster, then U, V), by macroblock parity
  __shared__ __align__(16) int16_t s_res[2][384];
  __shared__ int s_ticket;
  if (lane == 0) s_ticket = atomicAdd(a.rs.ticket, 1);
  __syncwarp();
  const int G = a.G, R = a.R, C = a.C;
  const int r = s_ticket / G, g = s_ticket % G;
  const int W = C * 16, H = R * 16, Wc = W / 2, Hc = H / 2;
  const bool luma = lane < 16, is_u = lane >= 16 && lane < 24;
  const int S = luma ? 16 : 8, WS = S + 4, Wp = luma ? W : Wc;
  const int row = luma ? lane : lane & 7;
  int* win = luma ? s_y : is_u ? s_u : s_v;
  uint8_t* out = luma ? a.Y + (size_t)g * H * W
                      : (is_u ? a.U : a.V) + (size_t)g * Hc * Wc;
  // this plane's unfiltered bottom rows of frame g: row r's is written
  // here, row r-1's read
  uint8_t* edge = (luma ? a.ey : is_u ? a.eu : a.ev) + (size_t)g * R * Wp;
  const size_t mb0 = (size_t)(g * R + r) * C;  // the row's first macroblock
  const uint8_t* tile = (luma ? a.ty : is_u ? a.tu : a.tv) + mb0 * S * S + row * S;
  const int16_t* resid = (luma ? a.ry : is_u ? a.ru : a.rv) + mb0 * S * S + row * S;
  const int res_at = luma ? row * 16 : (is_u ? 256 : 320) + row * 8;
  // the halo above: lanes 0-3 luma rows, 4-7 U rows, 8-11 V rows
  const int hp = lane >> 2, hrow = lane & 3, HS = hp ? 8 : 16;
  int* hwin = hp == 0 ? s_y : hp == 1 ? s_u : s_v;
  uint8_t* hplane = hp == 0 ? a.Y + (size_t)g * H * W
                    : (hp == 1 ? a.U : a.V) + (size_t)g * Hc * Wc;
  const int hW = hp ? Wc : W;
  int* prog = a.rs.progress + g * R + r;
  const int lag = a.rs.lag;
  const int y = r * S + row;             // this lane's plane row
  const int16_t* mbp = a.mbp + mb0 * NP;
  const bool hrow_mb = r > 0;
  int lu = 129;  // this lane's unfiltered pixel left of the macroblock

  // the next macroblock's tile row of this lane (4 pixels a word) and its
  // words 0-9 (two int16 a word), loaded a macroblock ahead; its residual
  // row copied into s_res
  uint32_t nx[4], nw[5];
  auto fetch = [&](int c) {
    const uint8_t* src = tile + (size_t)c * S * S;
    if (luma) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
      nx[0] = v.x; nx[1] = v.y; nx[2] = v.z; nx[3] = v.w;
    } else {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
      nx[0] = v.x; nx[1] = v.y; nx[2] = nx[3] = 0;
    }
    const uint32_t* w = reinterpret_cast<const uint32_t*>(mbp + (size_t)c * NP);
#pragma unroll
    for (int k = 0; k < 5; ++k) nw[k] = __ldg(w + k);
    const int16_t* rs = resid + (size_t)c * S * S;
    int16_t* rd = s_res[c & 1] + res_at;
    cp_async<16>(rd, rs);
    if (luma) cp_async<16>(rd + 8, rs + 8);
  };
  fetch(0);
  cp_async_commit();
  for (int c = 0; c < C; ++c) {
    const int x0 = c * S;
    uint32_t px[4] = {nx[0], nx[1], nx[2], nx[3]};
    int16_t p[10];  // words 0-9
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      p[2 * k] = (int16_t)nw[k];
      p[2 * k + 1] = (int16_t)(nw[k] >> 16);
    }
    // s_res[(c + 1) & 1] was macroblock c-1's: every lane is past it, and
    // its copy has landed (a group, empty at the end, each macroblock)
    cp_async_wait<1>();
    if (c + 1 < C) fetch(c + 1);
    cp_async_commit();
    const bool intra = p[3] != 0, nz = p[2] != 0;
    const bool bpred = intra && p[0] == B_PRED;
    const bool on = p[4] != 0;
    const bool do_left = on && c > 0, do_top = on && r > 0;
    const bool do_sb = p[9] == 0;
    int* own = win + (4 + row) * WS + 4;
    uint8_t* ebelow = edge + (size_t)r * Wp + x0;  // row r's, for row r+1

    int bm = 0;    // lanes 0-15: a B_PRED macroblock's b-mode ``lane``
    if (!intra) {
      // the tile row is the reconstruction: in place, kept for row r+1,
      // and the vertical edges (its own row and the kept left halo) before
      // the wait: they read nothing of row r-1
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if (k < S) own[k] = row_byte(px, k);
      if (row == S - 1) {
        if (luma) *reinterpret_cast<uint4*>(ebelow) = make_uint4(px[0], px[1], px[2], px[3]);
        else *reinterpret_cast<uint2*>(ebelow) = make_uint2(px[0], px[1]);
      }
      lu = (luma ? px[3] : px[1]) >> 24;
      if (on)
        lf_filter_window(s_y, s_u, s_v, lane, do_left, do_top, do_sb, p[5],
                         p[6], p[7], p[8], true, false);
    } else if (bpred && lane < 16) {
      bm = __ldg(a.bmode + (mb0 + c) * 16 + lane);
    }
    if (lane == 0 && r > 0) row_wait(prog - 1, min(c + lag, C));
    __syncwarp();
    // after the acquire: what row r-1 wrote during the launch, from L2
    int* hdst = hwin + hrow * (HS + 4) + 4;  // lanes 0-11: a halo row
    uint8_t* habove = hplane + (size_t)(r * HS - 4 + hrow) * hW + c * HS;
    uint32_t h[4];
    if (do_top && lane < 12) lf_halo_load(h, habove, hp == 0);
    uint32_t A[4] = {0x7f7f7f7fu, 0x7f7f7f7fu, 0x7f7f7f7fu, 0x7f7f7f7fu};
    int corner = 127, ar = 0x7f7f7f7f;  // above-left; above-right x4 (luma)
    if (intra && hrow_mb)  // the unfiltered row above
      intra_above_load(A, corner, ar, edge + (size_t)(r - 1) * Wp + x0, luma,
                       bpred, lane, c, C);
    if (do_top && lane < 12) lf_halo_put(hdst, h, HS);
    if (intra) {
      // this macroblock's residual in s_res: this lane's copy landed (the
      // B_PRED chain reads the others' after the barrier below)
      cp_async_wait<1>();
      const int16_t* res = s_res[c & 1];
      intra_mb_rows(own, luma, row, p[0], p[1], nz, bpred, bm, A, corner, ar,
                    c > 0 ? lu : 129, hrow_mb, c > 0, res, res_at, s_t, s_bm,
                    lane);
      if (bpred) {
        __syncwarp();
        bpred_chain(s_t, s_e, res, nz, s_bm, lane);
        if (luma) {
#pragma unroll
          for (int k = 0; k < 16; ++k) own[k] = s_t[1 + row][1 + k];
        }
      }
      // the unfiltered row, kept for row r+1 and the next macroblock
      uint32_t u[4];
      pack_row(u, own, S);
      if (row == S - 1) {
        if (luma) *reinterpret_cast<uint4*>(ebelow) = make_uint4(u[0], u[1], u[2], u[3]);
        else *reinterpret_cast<uint2*>(ebelow) = make_uint2(u[0], u[1]);
      }
      lu = (luma ? u[3] : u[1]) >> 24;
      __syncwarp();
      if (on)
        lf_filter_window(s_y, s_u, s_v, lane, do_left, do_top, do_sb, p[5],
                         p[6], p[7], p[8], true, false);
    }
    __syncwarp();
    if (on)
      lf_filter_window(s_y, s_u, s_v, lane, do_left, do_top, do_sb, p[5],
                       p[6], p[7], p[8], false, true);
    lf_mb_out(own, S, luma, out + (size_t)y * Wp + x0, do_left,
              do_top && lane < 12 && hrow > 0, hdst, HS, habove);
    __syncwarp();                       // every output of (r, c) written
    if (lane == 0) row_publish(prog, c + 1);
  }
}

// ------------------------------------------------- K4: the persistent form

struct IntraRowArgs {
  uint8_t *Y, *U, *V;           // unfiltered planes (G,16R,16C), (G,8R,8C)
  const uint8_t *ty, *tu, *tv;  // stage-B tiles (G,R,C,S,S)
  const int16_t *ry, *ru, *rv;  // residual tiles (G,R,C,S,S)
  const int16_t* mbp;           // (G,R,C,NP), words 0-3
  const uint8_t* bmode;         // (G,R,C,16)
  int G, R, C;
  RowSched rs;                  // progress (G, R)
};

// The column of the row's first intra macroblock at or after ``c`` (C if
// none): the warp reads 32 macroblocks' word 3 a step.
__device__ __forceinline__ int next_intra(const int16_t* mbp, int c, int C,
                                          int lane) {
  for (; c < C; c += 32) {
    const int k = c + lane;
    const unsigned m = __ballot_sync(
        0xffffffffu, k < C && __ldg(mbp + (size_t)k * NP + 3) != 0);
    if (m) return c + __ffs(m) - 1;
  }
  return C;
}

// The warps of K4's walk that reconstruct intra macroblocks meet here:
// warps 0 and 1 at a named barrier when NW > 1 (the others only copy).
template <int NW>
__device__ __forceinline__ void intra_sync() {
  if (NW > 1) asm volatile("bar.sync 1, 64;" ::: "memory");
  else __syncwarp();
}

// One block of NW warps per (row, frame) ticket, the frame inner.  First
// every warp copies a share of the row's inter macroblocks from their
// stage-B tiles into the planes (lanes 0-15 luma rows, 16-23 U rows, 24-31
// V rows, a word or two a lane): they read nothing the launch writes, so
// they go before any wait, and the row then publishes up to its first
// intra macroblock.  Then the row's intra macroblocks in order: each waits
// for row r-1 of its frame to have published min(c + lag, C) macroblocks,
// is reconstructed with K1's step (intra_above_load from the planes
// through L2, whose pixels above are unfiltered here; intra_mb_rows with
// the left pixels from the planes, written by this block; the B_PRED chain
// of 10 half-warp steps; the residual copied a macroblock ahead with
// cp.async), and publishes up to the next intra macroblock: one release a
// run of inter macroblocks.  With NW == 1 warp 0 reconstructs all three
// planes; with NW > 1 warp 0 the luma (its B_PRED chain) and warp 1 the
// chroma beside it, each into its own rows, and the other warps stop after
// the copies.
template <int NW>
__global__ void __launch_bounds__(32 * NW) intra_row_kernel(IntraRowArgs a) {
  constexpr int NR = NW > 1 ? 2 : 1;  // warps that reconstruct
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __shared__ int s_own[NR][32][16];   // each lane's reconstructed row
  __shared__ int s_t[17][21];         // a B_PRED macroblock's working tile
  __shared__ int s_e[2][13];          // the edges of the half-warps' sub-blocks
  __shared__ int s_bm[16];            // its b-modes
  // the residual tiles (luma raster, then U, V), by intra macroblock parity
  __shared__ __align__(16) int16_t s_res[NR][2][384];
  __shared__ int s_ticket;
  if (tid == 0) s_ticket = atomicAdd(a.rs.ticket, 1);
  __syncthreads();
  const int G = a.G, R = a.R, C = a.C;
  const int r = s_ticket / G, g = s_ticket % G;
  const int W = C * 16, H = R * 16, Wc = W / 2, Hc = H / 2;
  const bool luma = lane < 16, is_u = lane >= 16 && lane < 24;
  const int S = luma ? 16 : 8, Wp = luma ? W : Wc;
  const int row = luma ? lane : lane & 7;
  uint8_t* orow = (luma ? a.Y + (size_t)g * H * W
                        : (is_u ? a.U : a.V) + (size_t)g * Hc * Wc)
                  + (size_t)(r * S + row) * Wp;  // this lane's plane row
  const size_t mb0 = (size_t)(g * R + r) * C;  // the row's first macroblock
  const uint8_t* tile = (luma ? a.ty : is_u ? a.tu : a.tv) + mb0 * S * S + row * S;
  const int16_t* resid = (luma ? a.ry : is_u ? a.ru : a.rv) + mb0 * S * S + row * S;
  const int res_at = luma ? row * 16 : (is_u ? 256 : 320) + row * 8;
  const int16_t* mbp = a.mbp + mb0 * NP;
  int* prog = a.rs.progress + g * R + r;

  // the inter macroblocks, a warp every NW-th, two a step
  for (int c = warp; c < C; c += 2 * NW) {
    const int c2 = c + NW;
    const bool in1 = __ldg(mbp + (size_t)c * NP + 3) == 0;
    const bool in2 = c2 < C && __ldg(mbp + (size_t)c2 * NP + 3) == 0;
    if (luma) {
      uint4 v1 = make_uint4(0, 0, 0, 0), v2 = v1;
      if (in1) v1 = __ldg(reinterpret_cast<const uint4*>(tile + (size_t)c * 256));
      if (in2) v2 = __ldg(reinterpret_cast<const uint4*>(tile + (size_t)c2 * 256));
      if (in1) *reinterpret_cast<uint4*>(orow + c * 16) = v1;
      if (in2) *reinterpret_cast<uint4*>(orow + c2 * 16) = v2;
    } else {
      uint2 v1 = make_uint2(0, 0), v2 = v1;
      if (in1) v1 = __ldg(reinterpret_cast<const uint2*>(tile + (size_t)c * 64));
      if (in2) v2 = __ldg(reinterpret_cast<const uint2*>(tile + (size_t)c2 * 64));
      if (in1) *reinterpret_cast<uint2*>(orow + c * 8) = v1;
      if (in2) *reinterpret_cast<uint2*>(orow + c2 * 8) = v2;
    }
  }
  __syncthreads();
  int c = next_intra(mbp, 0, C, lane);
  if (tid == 0 && c > 0) row_publish(prog, c);
  if (warp >= NR) return;

  const bool rows = NR == 1 || (warp == 0) == luma;  // this lane's row is its
  int* own = s_own[warp][lane];                       // warp's to write
  int16_t (*res)[384] = s_res[warp];
  auto fetch = [&](int cc, int buf) {
    const int16_t* src = resid + (size_t)cc * S * S;
    cp_async<16>(res[buf] + res_at, src);
    if (luma) cp_async<16>(res[buf] + res_at + 8, src + 8);
  };
  if (c < C) fetch(c, 0);
  cp_async_commit();
  const int lag = a.rs.lag;
  for (int k = 0; c < C; ++k) {
    const int cn = next_intra(mbp, c + 1, C, lane);
    // res[(k + 1) & 1] was intra macroblock k-1's: every lane is past it,
    // and its copy has landed
    cp_async_wait<1>();
    if (cn < C) fetch(cn, (k + 1) & 1);
    cp_async_commit();
    const uint32_t w01 = __ldg(reinterpret_cast<const uint32_t*>(mbp + (size_t)c * NP));
    const uint32_t w23 = __ldg(reinterpret_cast<const uint32_t*>(mbp + (size_t)c * NP + 2));
    const int ymode = (int16_t)w01, uvmode = (int16_t)(w01 >> 16);
    const bool nz = (int16_t)w23 != 0;
    const bool bpred = warp == 0 && ymode == B_PRED;
    const int bm = bpred && luma ? __ldg(a.bmode + (mb0 + c) * 16 + lane) : 0;
    // the left pixel, (r, c-1)'s: copied or reconstructed by this block
    const int left = c > 0 ? __ldcg(orow + c * S - 1) : 129;
    if (tid == 0 && r > 0) row_wait(prog - 1, min(c + lag, C));
    intra_sync<NW>();
    uint32_t A[4] = {0x7f7f7f7fu, 0x7f7f7f7fu, 0x7f7f7f7fu, 0x7f7f7f7fu};
    int corner = 127, ar = 0x7f7f7f7f;  // above-left; above-right x4 (luma)
    if (r > 0)  // the row above, unfiltered: the planes themselves
      intra_above_load(A, corner, ar, orow - (size_t)(row + 1) * Wp + c * S,
                       luma, bpred, lane, c, C);
    // this macroblock's residual: this lane's copy landed (the B_PRED
    // chain reads the others' after the barrier in it)
    cp_async_wait<1>();
    const int16_t* rk = res[k & 1];
    intra_mb_rows(own, luma, row, ymode, uvmode, nz, bpred, bm, A, corner, ar,
                  left, r > 0, c > 0, rk, res_at, s_t, s_bm, lane, rows);
    if (bpred) {
      __syncwarp();
      bpred_chain(s_t, s_e, rk, nz, s_bm, lane);
      if (luma) {
#pragma unroll
        for (int j = 0; j < 16; ++j) own[j] = s_t[1 + row][1 + j];
      }
    }
    if (rows) {
      uint32_t u[4];
      pack_row(u, own, S);
      if (luma) *reinterpret_cast<uint4*>(orow + c * 16) = make_uint4(u[0], u[1], u[2], u[3]);
      else *reinterpret_cast<uint2*>(orow + c * 8) = make_uint2(u[0], u[1]);
    }
    intra_sync<NW>();                   // every output of (r, c) written
    if (tid == 0) row_publish(prog, cn);
    c = cn;
  }
}
