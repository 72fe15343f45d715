// encode_inter_frame (K8): the interframe encoder's macroblock loop on the
// card.  Motion-vector census, intra screening, ZEROMV / NEARESTMV /
// NEARMV and NEWMV by the iterated diamond search against LAST, mode
// decision, the winner's residues (the Y2 path for inter macroblocks, the
// full intra encode for intra ones, the trellis for intra macroblocks in
// two-pass) and the decoder-identical reconstruction of every macroblock
// of an interframe, for one or several quantizers at once (reference
// encoder/encode_inter.cc:231-369; plain version
// ops/enc_inter.py:encode_inter_frame_plain).
//
// Replaces the TPU kernel alfalfa_tpu/ops/enc_inter_pallas.py:
// encode_inter_frame (_inter_kernel), with H1 (enc_transforms.cuh) and H2
// (trellis.cuh) inside.  Kept from it: the arithmetic, the census, every
// tie-break (strict '<' in the order intra, ZERO, NEAREST, NEAR, NEW; the
// diamond's sites in the order (-1,0), (0,-1), (0,0), (0,1), (1,0)), the
// search's bounds test on the site before the best vector is added and the
// clamp of the site plus the best vector for its prediction only.  Not
// kept: the serial raster walk (the TPU runs one macroblock at a time
// because its scalar unit drives the window loads; every read of a
// macroblock is of an earlier anti-diagonal d = 2*row + col, so here a
// diagonal is one launch), the byte-packed padded references and their
// aligned window loads (reads clamp per index to the plane, which equals
// the padding of 32 >= 21 pixels), the phase-split layouts and permutation
// matmuls, the vmap over quantizers (here blockIdx.y) and the int32 costs
// with INF = 1 << 30 (int64 here, as the host loop's Python ints: the two
// could part only where a cost reaches 2^30).
//
// Design (simple and right first): one launch per diagonal, a block of
// 256 threads per (macroblock, quantizer).  Each thread owns one luma
// pixel: it filters its own prediction for every candidate vector straight
// from the reference (sixtap_device.cuh, the decoders' filter) and a block
// reduction gives SAD or variance; one thread runs the census and every
// decision.  The search is a loop of diamond steps, five sites each, two
// barriers a step.  The intra macroblock code is K7's (enc_mb_device.cuh):
// whole-mode screening, B_PRED with reconstruction in the loop under the
// interframe's non-contextual b-mode costs, the Y2 path and chroma.
// Neighbour state in device memory, written by earlier diagonals: the
// unfiltered reconstruction, the mode words (census) and, two-pass, the
// per-4x4 nonzero flags and Y2 chains (inter macroblocks write zero flags
// and pass the chains on).  Launches per call: 2*(R-1) + C, whatever the
// number of quantizers.
//
// Bound: on paper operations (each diamond site filters 256 pixels at about
// 100 integer operations each, and a macroblock scores tens of sites); in
// practice the critical path: each macroblock's search is a chain of
// dependent diamond steps, each two barriers and a one-thread decision,
// over 2*(R-1) + C dependent launches, and the intra macroblocks add K7's
// serial sub-block chain.

#include <cuda_runtime.h>
#include <stdint.h>

#include "enc_mb_device.cuh"  // the macroblock steps K8 shares with K7
#include "sixtap_device.cuh"  // the six-tap filter K8 shares with K2, K3

#define MODE_WORDS 32  // ymode, uvmode, is_inter, has_nonzero, mvx, mvy,
                       // chroma mvx, mvy, 16 b-modes, diamond sites
                       // evaluated, candidates scored, six-tap taps their
                       // luma predictions need, 5 zero
#define SITES 24
#define CANDS 25
#define TAPS 26
#define N_SCALARS 9    // y_dc, y_ac, y2_dc, y2_ac, uv_dc, uv_ac, rate and
                       // distortion multipliers, SAD per bit
#define MV_LIMIT 1023

struct InterArgs {
  MbPlanes p;                   // quantizer 0's planes and state; the
                                // kernel offsets them by blockIdx.y
  const uint8_t *ly, *lu, *lv;  // the LAST reference (16R,16C), (8R,8C)
  int16_t* coeffs;              // (Q,R,C,25,16) raster order
  int* modes;                   // (Q,R,C,MODE_WORDS)
  const int* scalars;           // (Q,N_SCALARS)
  const int* mbc;               // interframe macroblock mode costs (5)
  const int* ibc;               // interframe b-mode costs (10)
  const int* mvc2p;             // MV_COUNTS_TO_PROBS (6,4)
  const int* pcost;             // PROB_COST (256)
  const int* sadcost;           // SAD mv costs (256)
  const int* mvcost;            // mv component costs (4,1024)
  int realtime;                 // NEWMV only where row, column % 4 == 0
};

__constant__ int c_dx[5] = {-1, 0, 0, 0, 1};
__constant__ int c_dy[5] = {0, -1, 0, 1, 0};
// candidate k's mode: ZEROMV, NEARESTMV, NEARMV, NEWMV
__constant__ int c_mode[4] = {7, 5, 6, 8};

__device__ __forceinline__ void clamp_mv(int& x, int& y, int r, int c, int R,
                                         int C) {
  x = clampi(x, -(c * 128) - 128, (C - 1 - c) * 128 + 128);
  y = clampi(y, -(r * 128) - 128, (R - 1 - r) * 128 + 128);
}

// (4v + 4) >> 3, rounded symmetrically about zero
__device__ __forceinline__ int chroma_mv(int v) {
  return v > 0 ? (4 * v + 4) >> 3 : v < 0 ? -((-4 * v + 4) >> 3) : 0;
}

// The six-tap taps a 16x16 prediction at a vector of sub-pel phases
// (fx, fy) needs: the horizontal pass over 21 rows (16 without a vertical
// phase), the vertical pass over 16; a zero phase's pass is the identity.
__device__ __forceinline__ int luma_taps(int fx, int fy) {
  return 6 * 16 * ((fx ? (fy ? 21 : 16) : 0) + (fy ? 16 : 0));
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One block per (macroblock of diagonal d, quantizer blockIdx.y):
// r = r_lo + blockIdx.x, c = d - 2r.
__global__ void __launch_bounds__(256) enc_inter_diag_kernel(InterArgs a,
                                                             int d, int r_lo) {
  const int r = r_lo + blockIdx.x, c = d - 2 * r, qp = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  MbPlanes P = a.p;
  const int R = P.R, C = P.C, H = R * 16, W = C * 16;
  const size_t n_mb = (size_t)R * C;
  P.ry += qp * n_mb * 256;
  P.ru += qp * n_mb * 64;
  P.rv += qp * n_mb * 64;
  if (P.tc != nullptr) {
    P.ynz += qp * n_mb * 16;
    P.unz += qp * n_mb * 4;
    P.vnz += qp * n_mb * 4;
    P.y2c += qp * n_mb * 4;
  }
  const int* sc = a.scalars + qp * N_SCALARS;
  for (int i = 0; i < 6; ++i) P.q[i] = sc[i];
  P.rm = sc[6];
  P.dm = sc[7];
  const int sadw = sc[8];
  int* modes = a.modes + qp * n_mb * MODE_WORDS;
  const int mb = r * C + c;
  const int py = tid >> 4, px = tid & 15, Y = r * 16 + py, X = c * 16 + px;

  MB_SHARED(s);
  __shared__ int s_nb[3][3];        // above, left, above-left: is_inter,
                                    // mvx, mvy
  __shared__ int s_mv[4][2];        // candidates ZERO, NEAREST, NEAR, NEW
  __shared__ int s_en[4];           // ... and whether each is scored
  __shared__ long long s_rate[4];   // ... and their rates
  __shared__ int s_ref[2];          // the clamped best vector
  __shared__ int s_pick;            // the diamond step's site
  __shared__ int s_sites;           // diamond sites evaluated
  __shared__ int s_cands;           // candidates scored
  __shared__ int s_taps;            // six-tap taps of the sites and of the
                                    // candidates scored
  __shared__ int s_win;             // the winning candidate, -1: intra

  // the census's neighbour words (the barrier in mb_load publishes them)
  if (tid >= 180 && tid < 189) {
    const int k = tid - 180, n = k / 3, w = k % 3;
    const int nr = n == 1 ? r : r - 1, nc = n == 0 ? c : c - 1;
    const bool valid = n == 0 ? r > 0 : n == 1 ? c > 0 : (r > 0 && c > 0);
    s_nb[n][w] = valid ? modes[(size_t)(nr * C + nc) * MODE_WORDS
                               + (w == 0 ? 2 : 3 + w)] : 0;
  } else if (tid == 189) {
    s_sites = 0;
    s_taps = 0;
  }
  mb_load(P, s, r, c);
  __syncthreads();                 // the DC values
  whole_luma_costs(P, s, a.mbc, false);  // intra screening: s.wcost

  // ---- census (decoder/parse.py:mv_census) and mv_ref leaf costs ----
  if (tid == 0) {
    int sc4[4] = {0, 0, 0, 0}, mx[4] = {0, 0, 0, 0}, my[4] = {0, 0, 0, 0};
    int idx = 0;
    const int score[3] = {2, 2, 1};
    for (int n = 0; n < 3; ++n) {
      if (!s_nb[n][0]) continue;
      const int nx = s_nb[n][1], ny = s_nb[n][2];
      if (nx == 0 && ny == 0) {
        sc4[0] += score[n];
        continue;
      }
      if (nx != mx[idx] || ny != my[idx]) {
        ++idx;
        mx[idx] = nx;
        my[idx] = ny;
      }
      sc4[idx] += score[n];
    }
    // Scorer::calculate (macroblock.cc:156-172)
    if (sc4[3] && mx[idx] == mx[1] && my[idx] == my[1]) sc4[1] += sc4[3];
    if (sc4[2] > sc4[1]) {
      int t = sc4[1]; sc4[1] = sc4[2]; sc4[2] = t;
      t = mx[1]; mx[1] = mx[2]; mx[2] = t;
      t = my[1]; my[1] = my[2]; my[2] = t;
    }
    int bx = sc4[1] >= sc4[0] ? mx[1] : 0, by = sc4[1] >= sc4[0] ? my[1] : 0;
    clamp_mv(bx, by, r, c, R, C);
    s_ref[0] = bx;
    s_ref[1] = by;
    // the counts (no SPLITMV neighbours: count 3 is 0) -> probabilities
    const int* pc = a.pcost;
    const int p0 = a.mvc2p[sc4[0] * 4], p1 = a.mvc2p[sc4[1] * 4 + 1];
    const int p2 = a.mvc2p[sc4[2] * 4 + 2], p3 = a.mvc2p[3];
    s_rate[0] = pc[p0];
    s_rate[1] = pc[255 - p0] + pc[p1];
    s_rate[2] = pc[255 - p0] + pc[255 - p1] + pc[p2];
    s_rate[3] = pc[255 - p0] + pc[255 - p1] + pc[255 - p2] + pc[p3];
    s_mv[0][0] = s_mv[0][1] = 0;
    s_en[0] = 1;
    for (int k = 1; k < 3; ++k) {
      int x = mx[k], y = my[k];
      clamp_mv(x, y, r, c, R, C);
      s_mv[k][0] = x;
      s_mv[k][1] = y;
      s_en[k] = x != 0 || y != 0;
    }
  }
  __syncthreads();

  // ---- NEWMV: the iterated diamond search (encode_inter.cc:172-229) ----
  const int o = s.o[tid];
  const int brx = s_ref[0], bry = s_ref[1];
  const bool do_search = !a.realtime || ((r & 3) == 0 && (c & 3) == 0);
  int smx = 0, smy = 0;
  if (do_search) {
    int step = 512;
    while (step > 1) {
      int ox = smx, oy = smy, st = step, first = st / 2;
      while (st > 1) {
        int sad[5];
#pragma unroll
        for (int k = 0; k < 5; ++k) {
          const int sx = ox + st * c_dx[k], sy = oy + st * c_dy[k];
          sad[k] = 0;
          if (abs(sx) <= MV_LIMIT && abs(sy) <= MV_LIMIT) {
            int tx = sx + brx, ty = sy + bry;
            clamp_mv(tx, ty, r, c, R, C);
            sad[k] = abs(o - sixtap_pixel(a.ly, H, W, Y, X, tx, ty));
          }
          sad[k] = warp_sum(sad[k]);
          if (lane == 0) s.red[warp][k] = sad[k];
        }
        __syncthreads();
        if (tid == 0) {
          long long best = 0;
          int bk = -1;
          for (int k = 0; k < 5; ++k) {
            const int sx = ox + st * c_dx[k], sy = oy + st * c_dy[k];
            if (abs(sx) > MV_LIMIT || abs(sy) > MV_LIMIT) continue;
            ++s_sites;
            int tx = sx + brx, ty = sy + bry;
            clamp_mv(tx, ty, r, c, R, C);
            s_taps += luma_taps(tx & 7, ty & 7);
            long long dist = 0;
            for (int w = 0; w < 8; ++w) dist += s.red[w][k];
            const int cx = abs(clampi(sx >> 2, -255, 255));
            const int cy = abs(clampi(sy >> 2, -255, 255));
            const long long rate =
                ((long long)(a.sadcost[cy] + a.sadcost[cx]) * sadw + 128) >> 8;
            const long long cost = ((128 + rate) >> 8) + dist;
            if (bk < 0 || cost < best) { best = cost; bk = k; }
          }
          s_pick = bk;
        }
        __syncthreads();
        const int bk = s_pick;
        const int bx = ox + st * c_dx[bk], by = oy + st * c_dy[bk];
        if (bx == ox && by == oy) first = st / 2;
        ox = bx;
        oy = by;
        st /= 2;
      }
      // a restart that comes back where it started ends the search
      const bool same = ox == smx && oy == smy;
      smx = ox;
      smy = oy;
      step = same ? 1 : first;
    }
  }
  if (tid == 0) {
    // the search's vector plus the best one, not clamped again
    const int fx = smx + brx, fy = smy + bry;
    s_mv[3][0] = fx;
    s_mv[3][1] = fy;
    s_en[3] = do_search && (fx != 0 || fy != 0);
    const long long mvrate = (long long)a.mvcost[(smy < 0) * 1024 + abs(smy)] +
                             a.mvcost[(2 + (smx < 0)) * 1024 + abs(smx)];
    s_rate[3] += mvrate * 96 / 128;
  }
  __syncthreads();

  // ---- the four candidates by variance rd-cost against intra ----
  {
    long long acc[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int diff = 0;
      if (s_en[k]) diff = o - sixtap_pixel(a.ly, H, W, Y, X, s_mv[k][0], s_mv[k][1]);
      acc[k] = diff;
      acc[4 + k] = diff * diff;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      for (int w = 16; w; w >>= 1) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], w);
      if (lane == 0) s.red[warp][k] = acc[k];
    }
  }
  __syncthreads();
  if (tid == 0) {
    long long best = s.wcost;
    int win = -1, cands = 0;
    for (int k = 0; k < 4; ++k) {
      if (!s_en[k]) continue;
      ++cands;
      s_taps += luma_taps(s_mv[k][0] & 7, s_mv[k][1] & 7);
      long long sm = 0, sse = 0;
      for (int w = 0; w < 8; ++w) { sm += s.red[w][k]; sse += s.red[w][4 + k]; }
      const long long cost = rdcost(s_rate[k], sse - sm * sm / 256, P.rm, P.dm);
      if (cost < best) { best = cost; win = k; }
    }
    s_win = win;
    s_cands = cands;
  }
  __syncthreads();

  // ---- encode the winner ----
  const int win = s_win;
  const bool inter = win >= 0;
  int mvx = 0, mvy = 0, cmx = 0, cmy = 0;
  if (inter) {
    mvx = s_mv[win][0];
    mvy = s_mv[win][1];
    cmx = chroma_mv(mvx);
    cmy = chroma_mv(mvy);
    s.p16[tid] = sixtap_pixel(a.ly, H, W, Y, X, mvx, mvy);
    if (tid < 128) {
      const int pl = tid >> 6, k = tid & 63;
      s.pc[pl][k] = sixtap_pixel(pl ? a.lv : a.lu, H / 2, W / 2,
                                 r * 8 + (k >> 3), c * 8 + (k & 7), cmx, cmy);
    }
    __syncthreads();
    y2_path(P, s, false, TilePred{});   // inter macroblocks: no trellis
    chroma_code(P, s, r, c, false, TilePred{});
  } else {
    intra_mb(P, s, r, c, a.mbc, a.ibc, false);
  }
  const bool use_b = !inter && s.dec[0] != 0;
  const int wm = s.dec[1], um = s.dec[2];

  // ---- outputs: coefficients, mode words, luma, the trellis state ----
  int16_t* coeffs = a.coeffs + (qp * n_mb + mb) * 400;
  int any = 0;
  for (int i = tid; i < 400; i += 256) {
    const int blk = i >> 4, p = i & 15;
    int v;
    if (blk < 16) v = use_b ? s.bco[blk][p] : s.wco[blk][p];
    else if (blk < 24) v = s.uvco[blk - 16][p];
    else v = use_b ? 0 : s.y2[p];
    coeffs[i] = (int16_t)v;
    any |= v != 0;
  }
  P.ry[(size_t)Y * W + X] = (uint8_t)s.t[1 + py][1 + px];
  const int has_nonzero = __syncthreads_or(any);
  int* md = modes + (size_t)mb * MODE_WORDS;
  if (tid < 16) {
    md[8 + tid] = inter ? 0 : use_b ? s.bm[tid] : imode_to_bmode(wm);
  } else if (tid == 16) {
    md[0] = inter ? c_mode[win] : use_b ? B_PRED : wm;
    md[1] = inter ? 0 : um;
    md[2] = inter;
    md[3] = has_nonzero != 0;
    md[4] = mvx;
    md[5] = mvy;
    md[6] = cmx;
    md[7] = cmy;
  } else if (tid >= SITES && tid < MODE_WORDS) {
    md[tid] = tid == SITES ? s_sites : tid == CANDS ? s_cands
              : tid == TAPS ? s_taps : 0;
  }
  if (P.tc != nullptr) {
    const int C4 = 4 * C, C2 = 2 * C;
    if (tid >= 32 && tid < 48) {
      const int b = tid - 32, sr = b >> 2, sc = b & 3;
      P.ynz[(size_t)(4 * r + sr) * C4 + 4 * c + sc] =
          inter ? 0 : use_b ? s.bnz[b] : s.wnz[b];
    } else if (tid >= 64 && tid < 72) {
      const int k = tid - 64, pl = k >> 2, b = k & 3;
      (pl ? P.vnz : P.unz)[(size_t)(2 * r + (b >> 1)) * C2 + 2 * c + (b & 1)] =
          inter ? 0 : s.uvnz[k];
    } else if (tid == 96) {
      // an inter or B_PRED macroblock has no Y2 of its own: it passes its
      // neighbours' chains on
      uint8_t* y2 = P.y2c + (size_t)mb * 4;
      const bool pass = inter || use_b;
      y2[0] = pass ? s.ctx[16] : s.y2nz;
      y2[1] = pass ? s.ctx[17] : 1;
      y2[2] = pass ? s.ctx[18] : s.y2nz;
      y2[3] = pass ? s.ctx[19] : 1;
    }
  }
}

// Enqueue the 2*(R-1) + C diagonal launches of one frame at Q quantizers
// on ``stream`` (grid: the diagonal's macroblocks x Q); writes the number
// of kernel launches issued to ``*n_launched`` and returns
// cudaGetLastError() after the last one.  ``tc`` null: plain quantization
// (then vcost and the flag buffers are not read).
extern "C" int encode_inter_frame_launch(
    const void* oy, const void* ou, const void* ov, const void* ly,
    const void* lu, const void* lv, void* ry, void* ru, void* rv,
    void* coeffs, void* modes, const void* scalars, const void* mbc,
    const void* ibc, const void* mvc2p, const void* pcost,
    const void* sadcost, const void* mvcost, const void* tc,
    const void* vcost, void* ynz, void* unz, void* vnz, void* y2c,
    int realtime, int Q, int R, int C, void* stream, int* n_launched) {
  InterArgs a;
  MbPlanes& p = a.p;
  p.oy = (const uint8_t*)oy; p.ou = (const uint8_t*)ou; p.ov = (const uint8_t*)ov;
  p.ry = (uint8_t*)ry; p.ru = (uint8_t*)ru; p.rv = (uint8_t*)rv;
  p.tc = (const int*)tc;
  p.vcost = (const int*)vcost;
  p.ynz = (uint8_t*)ynz; p.unz = (uint8_t*)unz; p.vnz = (uint8_t*)vnz;
  p.y2c = (uint8_t*)y2c;
  p.R = R; p.C = C;
  for (int i = 0; i < 6; ++i) p.q[i] = 0;  // per quantizer, from scalars
  p.rm = p.dm = 0;
  a.ly = (const uint8_t*)ly; a.lu = (const uint8_t*)lu; a.lv = (const uint8_t*)lv;
  a.coeffs = (int16_t*)coeffs;
  a.modes = (int*)modes;
  a.scalars = (const int*)scalars;
  a.mbc = (const int*)mbc;
  a.ibc = (const int*)ibc;
  a.mvc2p = (const int*)mvc2p;
  a.pcost = (const int*)pcost;
  a.sadcost = (const int*)sadcost;
  a.mvcost = (const int*)mvcost;
  a.realtime = realtime;
  cudaStream_t st = (cudaStream_t)stream;
  int issued = 0;
  const int nd = 2 * (R - 1) + C;
  for (int d = 0; d < nd; ++d) {
    const int lo = d - C + 1;
    const int r_lo = lo > 0 ? (lo + 1) / 2 : 0;
    const int r_hi = d / 2 < R - 1 ? d / 2 : R - 1;
    const int n = r_hi - r_lo + 1;
    if (n <= 0) continue;
    enc_inter_diag_kernel<<<dim3(n, Q), 256, 0, st>>>(a, d, r_lo);
    ++issued;
  }
  *n_launched = issued;
  return (int)cudaGetLastError();
}
