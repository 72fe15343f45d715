// wavefront_decode: the sequentially dependent half of VP8 frame
// reconstruction for G frames in lockstep: intra prediction, then the
// normal loop filter, both over macroblock anti-diagonals d = 2*row + col.
//
// Replaces the TPU kernel alfalfa_tpu/ops/wavefront_pm.py:
// wavefront_frame_batch_pm (_intra_phase, _lf_phase).  Kept from it: the
// arithmetic and the two ordering rules.  (1) Intra prediction of MB (r, c)
// reads the UNFILTERED pixels of (r, c-1), (r-1, c-1), (r-1, c) and
// (r-1, c+1).  (2) The loop filter of MB (r, c) reads 4 and writes 3 pixels
// into (r, c-1) and (r-1, c) and must find them already filtered by their
// own macroblocks and by (r-1, c+1).  Both hold along d = 2r + c.  Not kept:
// the skewed diagonal storage, the ring of slabs, the pixel-major transpose
// and the permutation matmuls, which exist because that machine cannot
// gather or transpose cheaply.  Here the planes live in global memory (L2
// holds them at 720p G=16) and a block addresses its neighbours directly.
//
// Design (the simple right form): phases are separated in time instead of
// lagged.  One launch copies the inter-predicted tiles into the planes;
// then one launch per diagonal predicts the intra macroblocks of that
// diagonal (grid: MBs of the diagonal x G, 256 threads, B_PRED's 16
// sub-blocks as a serial chain in warp 0); when the whole frame is
// reconstructed, one launch per diagonal filters it in place (one warp per
// macroblock: lanes 0-15 luma rows/columns, 16-23 U, 24-31 V).  Stream
// order between launches is the only synchronisation, so nothing can wait
// on an unscheduled block.  Launches per frame: 1 + 2 * (2*(R-1) + C).
//
// Bound: on paper memory (tiles and residuals in, planes out, about
// 6 bytes per luma pixel); in practice the critical path: 2*(2(R-1)+C)
// dependent launches, each a small grid, with the B_PRED chain of 16
// dependent steps inside the intra ones.

#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
__device__ __forceinline__ int avg2(int x, int y) { return (x + y + 1) >> 1; }
__device__ __forceinline__ int avg3(int x, int y, int z) {
  return (x + 2 * y + z + 2) >> 2;
}

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

// One warp per macroblock of diagonal d.  Pass order inside a macroblock:
// left MB edge, interior vertical edges, top MB edge, interior horizontal
// edges.
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

  // vertical edges: one lane per pixel row of the macroblock
  if (lane < 16)
    lf_line<16>(s_y + (4 + lane) * 20, 1, do_left, do_sb, interior, mb_lim,
                sb_lim, hev_t);
  else if (lane < 24)
    lf_line<8>(s_u + (4 + lane - 16) * 12, 1, do_left, do_sb, interior, mb_lim,
               sb_lim, hev_t);
  else
    lf_line<8>(s_v + (4 + lane - 24) * 12, 1, do_left, do_sb, interior, mb_lim,
               sb_lim, hev_t);
  __syncwarp();
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

  lf_store<16>(s_y, Yp, W, r * 16, c * 16, do_left, do_top, lane, 32);
  lf_store<8>(s_u, Up, Wc, r * 8, c * 8, do_left, do_top, lane, 32);
  lf_store<8>(s_v, Vp, Wc, r * 8, c * 8, do_left, do_top, lane, 32);
}

// ------------------------------------------------------------------ host

// Enqueues the whole wavefront on ``stream``; returns cudaGetLastError()
// after the last launch (launch errors are sticky until read) and writes
// the number of kernel launches it issued to ``*n_launched``.
extern "C" int wavefront_decode_launch(
    void* Y, void* U, void* V, const void* ty, const void* tu, const void* tv,
    const void* ry, const void* ru, const void* rv, const void* mbp,
    const void* bmode, int G, int R, int C, void* stream, int* n_launched) {
  WaveArgs a;
  a.Y = (uint8_t*)Y; a.U = (uint8_t*)U; a.V = (uint8_t*)V;
  a.ty = (const uint8_t*)ty; a.tu = (const uint8_t*)tu; a.tv = (const uint8_t*)tv;
  a.ry = (const int16_t*)ry; a.ru = (const int16_t*)ru; a.rv = (const int16_t*)rv;
  a.mbp = (const int16_t*)mbp;
  a.bmode = (const uint8_t*)bmode;
  a.G = G; a.R = R; a.C = C;
  cudaStream_t st = (cudaStream_t)stream;
  int issued = 0;
  untile_kernel<<<dim3(C, R, G), 256, 0, st>>>(a);
  ++issued;
  const int nd = 2 * (R - 1) + C;
  for (int phase = 0; phase < 2; ++phase) {
    for (int d = 0; d < nd; ++d) {
      const int lo = d - C + 1;
      const int r_lo = lo > 0 ? (lo + 1) / 2 : 0;
      const int r_hi = d / 2 < R - 1 ? d / 2 : R - 1;
      const int n = r_hi - r_lo + 1;
      if (n <= 0) continue;
      if (phase == 0) intra_diag_kernel<<<dim3(n, G), 256, 0, st>>>(a, d, r_lo);
      else lf_diag_kernel<<<dim3(n, G), 32, 0, st>>>(a, d, r_lo);
      ++issued;
    }
  }
  *n_launched = issued;
  return (int)cudaGetLastError();
}
