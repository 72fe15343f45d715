// The interframe decision chain, one source for the serial interframe
// encoder (enc_inter.cu: K8) and the fast path's decisions (enc_decide.cu:
// K9): the census of the above, left and above-left macroblocks' vectors
// with the mv_ref leaf rates, the iterated diamond search for NEWMV, and the
// variance rd-cost of the four inter candidates against an intra cost.
// K9 is the decide-only instantiation; K8 follows it with its encode.
//
// One block of 256 threads decides one macroblock, a thread per luma pixel
// filtering its own prediction for every diamond site and candidate; each
// step is called by all the block's threads unless it says otherwise, and
// says what its last phase leaves unpublished.  Every tie-break is the host
// loop's (reference encoder/encode_inter.cc:172-369; the JAX package's
// encode_inter_np.py): the diamond's sites in the order (-1,0), (0,-1),
// (0,0), (0,1), (1,0), the first of least cost, the search's bounds test on
// the site before the best vector is added and the clamp of the site plus
// the best vector for its prediction only; the candidates by strict '<' in
// the order intra, ZERO, NEAREST, NEAR, NEW.  The census and its rates stay
// in one thread, in the order of the reference's Scorer::calculate.
//
// The decisions are taken redundantly: after the one barrier of a diamond
// step (or of the candidate sums) every warp reads the per-warp partial sums
// from shared memory, lane k scores site (or candidate) k, and a shuffle
// loop in site order takes the pick in every thread, so no one-thread
// section and no second barrier stands in the chain.  The partial sums of
// consecutive diamond steps alternate between two buffers, so a warp that
// runs ahead never overwrites sums a slower warp still reads.  The counts
// the kernels report (sites evaluated, candidates scored, six-tap taps)
// come out of the same loops, the same in every thread.
//
// The cost tables (SAD mv costs, mv component costs, PROB_COST,
// MV_COUNTS_TO_PROBS: 18.5 KB) live in shared memory, staged once per
// block: a block of the persistent kernels lives for a whole row.  As in
// enc_mb_device.cuh, the state is distinct __shared__ arrays (CHAIN_SHARED)
// behind references, and every step is inlined.
//
// The template parameter of decide_candidates is the cost arithmetic, each
// kernel's own: K8 keeps int64 costs and a candidate not scored never wins
// (Int64Costs, enc_inter.cu); K9 keeps the TPU kernel's int32 costs with
// INF = 1 << 30, where a candidate not scored costs INF and wins with
// vector (0, 0) over an intra cost above INF (Int32InfCosts,
// enc_decide.cu).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "intra_device.cuh"   // clampi
#include "sixtap_device.cuh"  // sixtap_pixel

#define MV_LIMIT 1023  // the search's vectors stay within +-MV_LIMIT

// candidate k's mode: ZEROMV, NEARESTMV, NEARMV, NEWMV
__constant__ int c_inter_mode[4] = {7, 5, 6, 8};

__device__ __forceinline__ void clamp_mv(int& x, int& y, int r, int c, int R,
                                         int C) {
  x = clampi(x, -(c * 128) - 128, (C - 1 - c) * 128 + 128);
  y = clampi(y, -(r * 128) - 128, (R - 1 - r) * 128 + 128);
}

// The six-tap taps a 16x16 prediction at a vector of sub-pel phases
// (fx, fy) needs: the horizontal pass over 21 rows (16 without a vertical
// phase), the vertical pass over 16; a zero phase's pass is the identity.
__device__ __forceinline__ int luma_taps(int fx, int fy) {
  return 6 * 16 * ((fx ? (fy ? 21 : 16) : 0) + (fy ? 16 : 0));
}

// sixtap_pixel's value with the passes a zero phase makes the identity
// skipped (phase 0 is the tap 128: (128 p + 64) >> 7 = p): a full-pel
// vector reads one pixel, a vector with one zero phase one six-tap pass.
// The phases are the block's, so the branch is uniform.
__device__ __forceinline__ int sixtap_pred(const uint8_t* __restrict__ ref,
                                           int H, int W, int y, int x,
                                           int mvx, int mvy) {
  const int fx = mvx & 7, fy = mvy & 7;
  const int yy = y + (mvy >> 3), xx = x + (mvx >> 3);
  int win[6];
  if (fy == 0) {
    const uint8_t* row = ref + (size_t)clampi(yy, 0, H - 1) * W;
    if (fx == 0) return row[clampi(xx, 0, W - 1)];
#pragma unroll
    for (int j = 0; j < 6; ++j) win[j] = row[clampi(xx - 2 + j, 0, W - 1)];
    return sixtap(win, 1, fx);
  }
  if (fx == 0) {
    const uint8_t* col = ref + clampi(xx, 0, W - 1);
#pragma unroll
    for (int k = 0; k < 6; ++k)
      win[k] = col[(size_t)clampi(yy - 2 + k, 0, H - 1) * W];
    return sixtap(win, 1, fy);
  }
  return sixtap_pixel(ref, H, W, y, x, mvx, mvy);
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The diamond's site k: (-1,0), (0,-1), (0,0), (0,1), (1,0).
__device__ __forceinline__ int site_dx(int k) {
  return k == 0 ? -1 : k == 4 ? 1 : 0;
}
__device__ __forceinline__ int site_dy(int k) {
  return k == 1 ? -1 : k == 3 ? 1 : 0;
}

// The chain's cost tables in device memory.
struct ChainTables {
  const int* mvc2p;    // MV_COUNTS_TO_PROBS (6,4)
  const int* pcost;    // PROB_COST (256)
  const int* sadcost;  // SAD mv costs (256)
  const int* mvcost;   // mv component costs (4,1024)
};

// A block's chain state in shared memory (see MbShared).
struct ChainShared {
  int (&sadcost)[256];     // the cost tables, staged once per block
  int (&mvcost)[4096];
  int (&pcost)[256];
  int (&mvc2p)[24];
  int (&nb)[3][3];         // above, left, above-left: is_inter, mvx, mvy
  int (&mv)[3][2];         // candidates ZERO, NEAREST, NEAR (NEW is in
                           // every thread's registers)
  int (&en)[3];            // ... whether each is scored
  long long (&rate)[4];    // ZERO, NEAREST, NEAR, NEW's mv_ref rates
  int (&ref)[2];           // the clamped best vector
  int (&sad)[2][8][5];     // per-warp SAD of a diamond step's five sites,
                           // consecutive steps alternating
  int (&var)[8][8];        // per-warp candidate sums: difference k, its
                           // square 4 + k
};

// Declares the shared arrays of the chain state and ``d``, over them.
#define CHAIN_SHARED(d)                                                    \
  __shared__ int d##_sadcost[256], d##_mvcost[4096], d##_pcost[256],      \
      d##_mvc2p[24], d##_nb[3][3], d##_mv[3][2], d##_en[3], d##_ref[2],   \
      d##_sad[2][8][5], d##_var[8][8];                                    \
  __shared__ long long d##_rate[4];                                       \
  ChainShared d{d##_sadcost, d##_mvcost, d##_pcost, d##_mvc2p, d##_nb,    \
                d##_mv,      d##_en,     d##_rate,  d##_ref,   d##_sad,   \
                d##_var}

// The cost tables into shared memory.  Unpublished.
__device__ __forceinline__ void chain_stage_tables(ChainShared& d,
                                                   const ChainTables& t) {
  const int tid = threadIdx.x;
  for (int i = tid; i < 4096; i += blockDim.x) d.mvcost[i] = t.mvcost[i];
  d.sadcost[tid] = t.sadcost[tid];
  d.pcost[tid] = t.pcost[tid];
  if (tid < 24) d.mvc2p[tid] = t.mvc2p[tid];
}

// Word k (0..8) of the census: the is_inter flag (word ``w_inter``) or a
// vector component (words ``w_mv``, ``w_mv`` + 1) of the above (k / 3 ==
// 0), left (1) or above-left (2) macroblock from its decision words
// (``stride`` ints a macroblock), 0 off the frame.  The words are written
// during the launch, by this block or another: L2 loads after the wait.
// Unpublished.
__device__ __forceinline__ void census_load(ChainShared& d, const int* words,
                                            int stride, int w_inter, int w_mv,
                                            int r, int c, int C, int k) {
  const int n = k / 3, w = k % 3;
  const int nr = n == 1 ? r : r - 1, nc = n == 0 ? c : c - 1;
  const bool valid = n == 0 ? r > 0 : n == 1 ? c > 0 : (r > 0 && c > 0);
  d.nb[n][w] = valid ? __ldcg(words + (size_t)(nr * C + nc) * stride +
                              (w == 0 ? w_inter : w_mv + w - 1))
                     : 0;
}

// One thread (decoder/parse.py:mv_census and Scorer::calculate,
// macroblock.cc:156-172): the clamped best vector, the vectors of ZERO,
// NEAREST and NEAR, whether each is scored (ZERO always, NEAREST and NEAR
// where their clamped vector is not zero) and the four mv_ref rates (no
// SPLITMV neighbours: count 3 is 0).  Unpublished.
__device__ __forceinline__ void census_decide(ChainShared& d, int r, int c,
                                              int R, int C) {
  int sc4[4] = {0, 0, 0, 0}, mx[4] = {0, 0, 0, 0}, my[4] = {0, 0, 0, 0};
  int idx = 0;
  const int score[3] = {2, 2, 1};
  for (int n = 0; n < 3; ++n) {
    if (!d.nb[n][0]) continue;
    const int nx = d.nb[n][1], ny = d.nb[n][2];
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
  if (sc4[3] && mx[idx] == mx[1] && my[idx] == my[1]) sc4[1] += sc4[3];
  if (sc4[2] > sc4[1]) {
    int t = sc4[1]; sc4[1] = sc4[2]; sc4[2] = t;
    t = mx[1]; mx[1] = mx[2]; mx[2] = t;
    t = my[1]; my[1] = my[2]; my[2] = t;
  }
  int bx = sc4[1] >= sc4[0] ? mx[1] : 0, by = sc4[1] >= sc4[0] ? my[1] : 0;
  clamp_mv(bx, by, r, c, R, C);
  d.ref[0] = bx;
  d.ref[1] = by;
  const int* pc = d.pcost;
  const int p0 = d.mvc2p[sc4[0] * 4], p1 = d.mvc2p[sc4[1] * 4 + 1];
  const int p2 = d.mvc2p[sc4[2] * 4 + 2], p3 = d.mvc2p[3];
  d.rate[0] = pc[p0];
  d.rate[1] = pc[255 - p0] + pc[p1];
  d.rate[2] = pc[255 - p0] + pc[255 - p1] + pc[p2];
  d.rate[3] = pc[255 - p0] + pc[255 - p1] + pc[255 - p2] + pc[p3];
  d.mv[0][0] = d.mv[0][1] = 0;
  d.en[0] = 1;
  for (int k = 1; k < 3; ++k) {
    int x = mx[k], y = my[k];
    clamp_mv(x, y, r, c, R, C);
    d.mv[k][0] = x;
    d.mv[k][1] = y;
    d.en[k] = x != 0 || y != 0;
  }
}

// NEWMV: the iterated diamond search (encode_inter.cc:172-229) from the
// clamped best vector (brx, bry) for this thread's pixel ``o`` = original
// (Y, X) of the macroblock (r, c), SAD plus the SAD mv cost.  Returns the
// search's vector in (smx, smy) and adds the sites evaluated and their
// six-tap taps to ``sites`` and ``taps``, the same in every thread.  One
// barrier a step; the last step's sums stay in d.sad until two steps of
// the next macroblock's search.  After the first step the centre site is
// the last step's pick, whose cost is known: it is counted, not filtered
// again.
__device__ __forceinline__ void diamond_search(
    ChainShared& d, int o, const uint8_t* __restrict__ ly, int H, int W,
    int Y, int X, int r, int c, int R, int C, int sadw, int brx, int bry,
    int& smx, int& smy, int& sites, int& taps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int buf = 0;
  bool known = false;  // the centre's cost, after the first step
  long long centre = 0;
  smx = smy = 0;
  int step = 512;
  while (step > 1) {
    int ox = smx, oy = smy, st = step, first = st / 2;
    while (st > 1) {
      int sad[5];
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const int sx = ox + st * site_dx(k), sy = oy + st * site_dy(k);
        sad[k] = 0;
        if (k == 2 && known) continue;
        if (abs(sx) <= MV_LIMIT && abs(sy) <= MV_LIMIT) {
          int tx = sx + brx, ty = sy + bry;
          clamp_mv(tx, ty, r, c, R, C);
          sad[k] = abs(o - sixtap_pred(ly, H, W, Y, X, tx, ty));
        }
        sad[k] = warp_sum(sad[k]);
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < 5; ++k) d.sad[buf][warp][k] = sad[k];
      }
      __syncthreads();
      // lane k < 5 scores site k; a site out of bounds costs the most and
      // is never taken (the centre, in bounds, always costs less)
      long long cost = 0x7fffffffffffffffll;
      int tv = 0;  // (six-tap taps << 1) | 1 for a site in bounds
      if (lane < 5) {
        const int sx = ox + st * site_dx(lane), sy = oy + st * site_dy(lane);
        if (abs(sx) <= MV_LIMIT && abs(sy) <= MV_LIMIT) {
          int tx = sx + brx, ty = sy + bry;
          clamp_mv(tx, ty, r, c, R, C);
          tv = (luma_taps(tx & 7, ty & 7) << 1) | 1;
          if (lane == 2 && known) {
            cost = centre;
          } else {
            int dist = 0;
#pragma unroll
            for (int w = 0; w < 8; ++w) dist += d.sad[buf][w][lane];
            const int cx = abs(clampi(sx >> 2, -255, 255));
            const int cy = abs(clampi(sy >> 2, -255, 255));
            const long long rate =
                ((long long)(d.sadcost[cy] + d.sadcost[cx]) * sadw + 128) >>
                8;
            cost = ((128 + rate) >> 8) + dist;
          }
        }
      }
      int bk = 0;
      long long best = 0x7fffffffffffffffll;
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const long long ck = __shfl_sync(0xffffffffu, cost, k);
        const int tk = __shfl_sync(0xffffffffu, tv, k);
        sites += tk & 1;
        taps += tk >> 1;
        if (ck < best) { best = ck; bk = k; }
      }
      centre = best;
      known = true;
      const int bx = ox + st * site_dx(bk), by = oy + st * site_dy(bk);
      if (bx == ox && by == oy) first = st / 2;
      ox = bx;
      oy = by;
      st /= 2;
      buf ^= 1;
    }
    // a restart that comes back where it started ends the search
    const bool same = ox == smx && oy == smy;
    smx = ox;
    smy = oy;
    step = same ? 1 : first;
  }
}

// NEW's rate: its mv_ref rate (the census published) plus the cost of the
// search's vector (smx, smy), the same in every thread.
__device__ __forceinline__ long long new_rate(const ChainShared& d, int smx,
                                              int smy) {
  const long long mvrate = (long long)d.mvcost[(smy < 0) * 1024 + abs(smy)] +
                           d.mvcost[(2 + (smx < 0)) * 1024 + abs(smx)];
  return d.rate[3] + mvrate * 96 / 128;
}

// The per-warp sums of this thread's difference from each candidate's
// prediction (d.var[w][k]) and of its square (d.var[w][4 + k]), zero for a
// candidate not scored: ZERO, NEAREST, NEAR from the census (published),
// NEW at (nx, ny) where ``en_new``.  Unpublished.
__device__ __forceinline__ void candidate_sums(ChainShared& d, int o,
                                               const uint8_t* __restrict__ ly,
                                               int H, int W, int Y, int X,
                                               int nx, int ny, bool en_new) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int acc[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool en = k < 3 ? d.en[k] != 0 : en_new;
    const int mx = k < 3 ? d.mv[k][0] : nx, my = k < 3 ? d.mv[k][1] : ny;
    int diff = 0;
    if (en) diff = o - sixtap_pred(ly, H, W, Y, X, mx, my);
    acc[k] = diff;
    acc[4 + k] = diff * diff;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = warp_sum(acc[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) d.var[warp][k] = acc[k];
  }
}

// Every warp, after the barrier that publishes candidate_sums: the winner
// by strict '<' in the order intra (cost ``intra``), ZERO, NEAREST, NEAR,
// NEW (-1: intra), the same in every thread; adds the candidates scored
// and their six-tap taps to ``cands`` and ``taps``.  ``Costs`` is the
// kernel's cost arithmetic: a type T, T cost(rate, variance, rm, dm) and
// T kUnscored, what a candidate not scored costs.
template <typename Costs>
__device__ __forceinline__ int decide_candidates(
    const ChainShared& d, typename Costs::T intra, int rm, int dm, int nx,
    int ny, bool en_new, long long rate_new, int& cands, int& taps) {
  typedef typename Costs::T T;
  const int lane = threadIdx.x & 31;
  T cost = Costs::kUnscored;
  if (lane < 4 && (lane < 3 ? d.en[lane] != 0 : en_new)) {
    long long sm = 0, sse = 0;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      sm += d.var[w][lane];
      sse += d.var[w][4 + lane];
    }
    cost = Costs::cost(lane < 3 ? d.rate[lane] : rate_new, sse - sm * sm / 256,
                       rm, dm);
  }
  T best = intra;
  int win = -1;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const T ck = __shfl_sync(0xffffffffu, cost, k);
    if (k < 3 ? d.en[k] != 0 : en_new) {
      ++cands;
      taps += k < 3 ? luma_taps(d.mv[k][0] & 7, d.mv[k][1] & 7)
                    : luma_taps(nx & 7, ny & 7);
    }
    if (ck < best) { best = ck; win = k; }
  }
  return win;
}
