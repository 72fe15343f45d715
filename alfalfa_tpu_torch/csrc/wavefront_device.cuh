// Device code of the decode wavefront, shared by the three C entries of
// wavefront.cu: K1 wavefront_decode_launch (GOP batch: untile, intra, loop
// filter), K4 intra_frame_launch (untile, intra) and K5 loop_filter_launch
// (loop filter alone).  One copy of the math: untile_kernel,
// intra_diag_kernel, lf_diag_kernel (K1's filter phase) and lf_row_kernel
// (K5) with their helpers; the two filter kernels share lf_filter_window.
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

struct WaveArgs {
  uint8_t *Y, *U, *V;           // planes (G,16R,16C), (G,8R,8C): in place
  const uint8_t *ty, *tu, *tv;  // stage-B tiles (G,R,C,S,S)
  const int16_t *ry, *ru, *rv;  // residual tiles (G,R,C,S,S)
  const int16_t* mbp;           // (G,R,C,NP)
  const uint8_t* bmode;         // (G,R,C,16)
  int G, R, C;
};

// ---------------------------------------------------------------- untile

__global__ void untile_kernel(WaveArgs a) {
  const int c = blockIdx.x, r = blockIdx.y, g = blockIdx.z;
  const int mb = (g * a.R + r) * a.C + c;
  const int tid = threadIdx.x;
  const int W = a.C * 16, H = a.R * 16, Wc = W / 2, Hc = H / 2;
  {
    const int py = tid >> 4, px = tid & 15;
    a.Y[((size_t)g * H + r * 16 + py) * W + c * 16 + px] =
        a.ty[(size_t)mb * 256 + tid];
  }
  if (tid < 128) {
    const int k = tid & 63, cy = k >> 3, cx = k & 7;
    const size_t o = ((size_t)g * Hc + r * 8 + cy) * Wc + c * 8 + cx;
    if (tid < 64) a.U[o] = a.tu[(size_t)mb * 64 + k];
    else a.V[o] = a.tv[(size_t)mb * 64 + k];
  }
}

// ----------------------------------------------------------------- intra

// One block per macroblock of diagonal d: r = r_lo + blockIdx.x, c = d - 2r.
__global__ void intra_diag_kernel(WaveArgs a, int d, int r_lo) {
  const int r = r_lo + blockIdx.x, c = d - 2 * r, g = blockIdx.y;
  const int mb = (g * a.R + r) * a.C + c;
  const int16_t* p = a.mbp + (size_t)mb * NP;
  if (!p[3]) return;  // inter macroblock: already in the planes
  const int ymode = p[0], uvmode = p[1];
  const bool nz = p[2] != 0;
  const bool hrow = r > 0, hcol = c > 0, lastc = c == a.C - 1;
  const int tid = threadIdx.x;
  const int W = a.C * 16, H = a.R * 16, Wc = W / 2, Hc = H / 2;
  uint8_t* Yp = a.Y + (size_t)g * H * W;
  uint8_t* Up = a.U + (size_t)g * Hc * Wc;
  uint8_t* Vp = a.V + (size_t)g * Hc * Wc;
  const int y0 = r * 16, x0 = c * 16, cy0 = r * 8, cx0 = c * 8;

  __shared__ int s_e[21];      // above-left, above x16, above-right x4
  __shared__ int s_l[16];      // left column
  __shared__ int s_ce[2][9];   // chroma above-left + above x8 (U, V)
  __shared__ int s_cl[2][8];   // chroma left column
  __shared__ int s_dc[3];
  __shared__ int s_t[17][21];  // B_PRED working tile with its edges

  if (tid < 16) {
    s_e[1 + tid] = hrow ? Yp[(size_t)(y0 - 1) * W + x0 + tid] : 127;
  } else if (tid < 20) {
    const int k = tid - 16;
    s_e[17 + k] = !hrow ? 127
                  : lastc ? Yp[(size_t)(y0 - 1) * W + x0 + 15]
                          : Yp[(size_t)(y0 - 1) * W + x0 + 16 + k];
  } else if (tid == 20) {
    s_e[0] = !hrow ? 127 : hcol ? Yp[(size_t)(y0 - 1) * W + x0 - 1] : 129;
  } else if (tid >= 32 && tid < 48) {
    const int k = tid - 32;
    s_l[k] = hcol ? Yp[(size_t)(y0 + k) * W + x0 - 1] : 129;
  } else if (tid >= 64 && tid < 128) {
    const int pl = (tid - 64) >> 5, k = (tid - 64) & 31;
    const uint8_t* P = pl ? Vp : Up;
    if (k < 8) {
      s_ce[pl][1 + k] = hrow ? P[(size_t)(cy0 - 1) * Wc + cx0 + k] : 127;
    } else if (k == 8) {
      s_ce[pl][0] = !hrow ? 127 : hcol ? P[(size_t)(cy0 - 1) * Wc + cx0 - 1] : 129;
    } else if (k >= 16 && k < 24) {
      s_cl[pl][k - 16] = hcol ? P[(size_t)(cy0 + k - 16) * Wc + cx0 - 1] : 129;
    }
  }
  __syncthreads();
  if (tid == 0) {
    int sa = 0, sl = 0;
    for (int k = 0; k < 16; ++k) { sa += s_e[1 + k]; sl += s_l[k]; }
    s_dc[0] = dc_value(sa, sl, hrow, hcol, 4);
  } else if (tid == 32 || tid == 64) {
    const int pl = tid == 64;
    int sa = 0, sl = 0;
    for (int k = 0; k < 8; ++k) { sa += s_ce[pl][1 + k]; sl += s_cl[pl][k]; }
    s_dc[1 + pl] = dc_value(sa, sl, hrow, hcol, 3);
  }
  __syncthreads();

  // chroma: threads 0..63 U, 64..127 V
  if (tid < 128) {
    const int pl = tid >> 6, k = tid & 63, cy = k >> 3, cx = k & 7;
    const int pred = whole_pixel(uvmode, s_dc[1 + pl], s_ce[pl][1 + cx],
                                 s_cl[pl][cy], s_ce[pl][0]);
    const int16_t* res = pl ? a.rv : a.ru;
    const int v = clampi(pred + (nz ? (int)res[(size_t)mb * 64 + k] : 0), 0, 255);
    (pl ? Vp : Up)[(size_t)(cy0 + cy) * Wc + cx0 + cx] = (uint8_t)v;
  }

  const int py = tid >> 4, px = tid & 15;
  if (ymode != B_PRED) {
    const int pred = whole_pixel(ymode, s_dc[0], s_e[1 + px], s_l[py], s_e[0]);
    const int v = clampi(pred + (nz ? (int)a.ry[(size_t)mb * 256 + tid] : 0), 0, 255);
    Yp[(size_t)(y0 + py) * W + x0 + px] = (uint8_t)v;
    return;
  }

  // B_PRED: 16 sub-blocks in raster order, each from reconstructed
  // neighbours.  s_t row 0 / column 0 hold the macroblock's edges; cell
  // (1+y, 1+x) is pixel (y, x).
  if (tid < 21) s_t[0][tid] = s_e[tid];
  else if (tid >= 32 && tid < 48) s_t[1 + tid - 32][0] = s_l[tid - 32];
  __syncthreads();
  if (tid < 32) {
    const int ly = (tid >> 2) & 3, lx = tid & 3;
    for (int sb = 0; sb < 16; ++sb) {
      const int sr = sb >> 2, sc = sb & 3;
      int val = 0;
      if (tid < 16) {
        int E[13];
        // the right-most sub-block takes its above-right from the row above
        // the macroblock in every sub-block row
        const int arow = sc == 3 ? 0 : sr * 4;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          E[3 - k] = s_t[sr * 4 + 1 + k][sc * 4];
          E[5 + k] = s_t[sr * 4][sc * 4 + 1 + k];
          E[9 + k] = s_t[arow][sc * 4 + 5 + k];
        }
        E[4] = s_t[sr * 4][sc * 4];
        const int pred = bpred_pixel(a.bmode[(size_t)mb * 16 + sb], E, ly, lx);
        const int res =
            nz ? (int)a.ry[(size_t)mb * 256 + (sr * 4 + ly) * 16 + sc * 4 + lx] : 0;
        val = clampi(pred + res, 0, 255);
      }
      __syncwarp();
      if (tid < 16) s_t[sr * 4 + 1 + ly][sc * 4 + 1 + lx] = val;
      __syncwarp();
    }
  }
  __syncthreads();
  Yp[(size_t)(y0 + py) * W + x0 + px] = (uint8_t)s_t[1 + py][1 + px];
}

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

// Window (S+4)^2 of one plane: 4-pixel halo above and left of the MB.
template <int S>
__device__ void lf_load(int* win, const uint8_t* P, int Wp, int y0, int x0,
                        bool do_left, bool do_top, int lane, int nlanes) {
  constexpr int WS = S + 4;
  for (int i = lane; i < WS * WS; i += nlanes) {
    const int wy = i / WS, wx = i % WS;
    int v = 0;
    const bool in_left = wx < 4, in_top = wy < 4;
    if ((!in_left && !in_top) || (in_left && !in_top && do_left) ||
        (in_top && !in_left && do_top))
      v = P[(size_t)(y0 - 4 + wy) * Wp + x0 - 4 + wx];
    win[i] = v;
  }
}

template <int S>
__device__ void lf_store(const int* win, uint8_t* P, int Wp, int y0, int x0,
                         bool do_left, bool do_top, int lane, int nlanes) {
  constexpr int WS = S + 4;
  for (int i = lane; i < WS * WS; i += nlanes) {
    const int wy = i / WS, wx = i % WS;
    const bool own = wy >= 4 && wx >= 4;
    const bool left = wy >= 4 && wx >= 1 && wx < 4 && do_left;
    const bool top = wx >= 4 && wy >= 1 && wy < 4 && do_top;
    if (own || left || top)
      P[(size_t)(y0 - 4 + wy) * Wp + x0 - 4 + wx] = (uint8_t)win[i];
  }
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

// One warp per macroblock of diagonal d (K1's filter phase).
__global__ void lf_diag_kernel(WaveArgs a, int d, int r_lo) {
  const int r = r_lo + blockIdx.x, c = d - 2 * r, g = blockIdx.y;
  const int mb = (g * a.R + r) * a.C + c;
  const int16_t* p = a.mbp + (size_t)mb * NP;
  if (p[4] == 0) return;
  const int interior = p[5], mb_lim = p[6], sb_lim = p[7], hev_t = p[8];
  const bool do_sb = p[9] == 0, do_left = c > 0, do_top = r > 0;
  const int lane = threadIdx.x;
  const int W = a.C * 16, H = a.R * 16, Wc = W / 2, Hc = H / 2;
  uint8_t* Yp = a.Y + (size_t)g * H * W;
  uint8_t* Up = a.U + (size_t)g * Hc * Wc;
  uint8_t* Vp = a.V + (size_t)g * Hc * Wc;

  __shared__ int s_y[20 * 20];
  __shared__ int s_u[12 * 12];
  __shared__ int s_v[12 * 12];
  lf_load<16>(s_y, Yp, W, r * 16, c * 16, do_left, do_top, lane, 32);
  lf_load<8>(s_u, Up, Wc, r * 8, c * 8, do_left, do_top, lane, 32);
  lf_load<8>(s_v, Vp, Wc, r * 8, c * 8, do_left, do_top, lane, 32);
  __syncwarp();
  lf_filter_window(s_y, s_u, s_v, lane, do_left, do_top, do_sb, interior,
                   mb_lim, sb_lim, hev_t);
  lf_store<16>(s_y, Yp, W, r * 16, c * 16, do_left, do_top, lane, 32);
  lf_store<8>(s_u, Up, Wc, r * 8, c * 8, do_left, do_top, lane, 32);
  lf_store<8>(s_v, Vp, Wc, r * 8, c * 8, do_left, do_top, lane, 32);
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
    if (do_top && lane < 12) {
      const uint8_t* src = hplane + (size_t)(r * HS - 4 + hrow) * hW + c * HS;
      uint32_t h[4];
      if (hp == 0) {
        const uint4 v = __ldcg(reinterpret_cast<const uint4*>(src));
        h[0] = v.x; h[1] = v.y; h[2] = v.z; h[3] = v.w;
      } else {
        const uint2 v = __ldcg(reinterpret_cast<const uint2*>(src));
        h[0] = v.x; h[1] = v.y; h[2] = h[3] = 0;
      }
      int* dst = hwin + hrow * (HS + 4) + 4;
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if (k < HS) dst[k] = (h[k >> 2] >> (8 * (k & 3))) & 255;
    }
    __syncwarp();
    if (on)
      lf_filter_window(s_y, s_u, s_v, lane, do_left, do_top, p[5] == 0, p[1],
                       p[2], p[3], p[4], false, true);
    // this lane's row: the macroblock's pixels, and with the left edge
    // filtered the left neighbour's last 3
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      uint32_t v = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * w + k < S) v |= (uint32_t)own[4 * w + k] << (8 * k);
      px[w] = v;
    }
    uint8_t* dst = out + (size_t)y * Wp + x0;
    if (luma) *reinterpret_cast<uint4*>(dst) = make_uint4(px[0], px[1], px[2], px[3]);
    else *reinterpret_cast<uint2*>(dst) = make_uint2(px[0], px[1]);
    if (do_left)
      for (int k = 1; k < 4; ++k) dst[k - 4] = (uint8_t)own[k - 4];
    // with the top edge filtered, the last 3 rows of the macroblock above
    if (do_top && lane < 12 && hrow > 0) {
      const int* srcw = hwin + hrow * (HS + 4) + 4;
      uint32_t h[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        uint32_t v = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (4 * w + k < HS) v |= (uint32_t)srcw[4 * w + k] << (8 * k);
        h[w] = v;
      }
      uint8_t* hd = hplane + (size_t)(r * HS - 4 + hrow) * hW + c * HS;
      if (hp == 0) *reinterpret_cast<uint4*>(hd) = make_uint4(h[0], h[1], h[2], h[3]);
      else *reinterpret_cast<uint2*>(hd) = make_uint2(h[0], h[1]);
    }
    // the next macroblock's left halo: this one's last 4 columns, kept
#pragma unroll
    for (int k = 0; k < 4; ++k) own[k - 4] = own[S - 4 + k];
    __syncwarp();                       // every output of (r, c) written
    if (lane == 0) row_publish(prog, c + 1);
  }
}
