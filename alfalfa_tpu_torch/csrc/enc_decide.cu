// decide_inter_frame (K9): the mode and motion-vector decisions of every
// macroblock of a fast rt interframe on the card, for one or several
// quantizers at once: the census of the committed neighbours, ZEROMV /
// NEARESTMV / NEARMV, and NEWMV by the iterated diamond search where row
// and column are multiples of 4, each by variance rd-cost of its six-tap
// prediction from LAST against a given intra cost per macroblock
// (reference encoder/encode_inter.cc:172-369; plain version
// ops/enc_decide.py:decide_inter_frame_plain).
//
// Replaces the TPU kernel alfalfa_tpu/ops/enc_decide_pallas.py:
// decide_inter_frame (_decide_kernel).  Kept from it: the arithmetic, every
// tie-break (strict '<' in the order intra, ZERO, NEAREST, NEAR, NEW), the
// int32 costs with INF = 1 << 30 (a candidate not scored costs INF and wins
// over an intra cost above it; no cost reaches 2^31: variance <= 256 *
// 255^2 times a distortion multiplier <= 100, plus a rate under 2^24), the
// vector (0, 0) of a candidate not scored.  Not kept: the raster walk with
// its two-row ring of committed decisions (every macroblock reads only its
// left, above and above-left neighbours, all on the earlier anti-diagonal
// d = row + col, so here a diagonal is one launch), the phase-split source
// layout, the byte-packed padded reference with its aligned window loads
// (reads clamp per index to the plane, which equals the padding), and the
// vmap over quantizers (here blockIdx.y, with one intra cost row each).
//
// Design: K8's decision chain (the steps below, a copy of enc_inter.cu's)
// without K8's encode: one launch per diagonal, a block of 256
// threads per (macroblock, quantizer), a thread per luma pixel filtering
// its own prediction for every diamond site and candidate, block reductions
// for SAD and variance, one thread for the census and every decision.
// Launches per call: R + C - 1, whatever the number of quantizers.
//
// Bound: on paper operations (the six-tap taps of every scored vector, and
// the SAD and variance terms); in practice the critical path: each searching
// macroblock's chain of dependent diamond steps, two barriers and a
// one-thread decision each, over R + C - 1 dependent launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "intra_device.cuh"   // clampi
#include "sixtap_device.cuh"  // sixtap_pixel

#define DECIDE_WORDS 8  // is_inter, mode, mvx, mvy, diamond sites evaluated,
                        // candidates scored, six-tap taps of their luma
                        // predictions, 0
#define N_SCALARS 9     // y_dc, y_ac, y2_dc, y2_ac, uv_dc, uv_ac, rate and
                        // distortion multipliers, SAD per bit
#define DECIDE_INF (1 << 30)

// ---- the decision steps ------------------------------------------------
//
// The census of the above, left and above-left macroblocks' vectors with
// the mv_ref leaf costs, the iterated diamond search for NEWMV, and the sums
// the variance rd-cost of the four inter candidates needs.  The code is
// K8's (enc_inter.cu), which keeps its own copy inline: called through these
// steps, K8 ran 1-4 % slower at 720p and 5-7 % at 176x144 on an H100 than
// with the chain inline, every case, in one run (PERF.md).  One block of 256
// threads decides one macroblock, a thread per luma pixel; each step is
// called by all the block's threads unless it says otherwise, and says what
// its last phase leaves unpublished.  Every tie-break is the host loop's
// (reference encoder/encode_inter.cc:172-369; the JAX package's
// encode_inter_np.py): the diamond's sites in the order (-1,0), (0,-1),
// (0,0), (0,1), (1,0), the first of least cost, the search's bounds test on
// the site before the best vector is added and the clamp of the site plus
// the best vector for its prediction only.  As in enc_mb_device.cuh, the
// state is distinct __shared__ arrays (DECIDE_SHARED) behind references,
// and every step is inlined.

#define MV_LIMIT 1023  // the search's vectors stay within +-MV_LIMIT

__constant__ int c_dx[5] = {-1, 0, 0, 0, 1};
__constant__ int c_dy[5] = {0, -1, 0, 1, 0};

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

// A macroblock's decision state in shared memory (see MbShared).
struct DecideShared {
  int (&nb)[3][3];         // above, left, above-left: is_inter, mvx, mvy
  int (&mv)[4][2];         // candidates ZERO, NEAREST, NEAR, NEW
  int (&en)[4];            // ... whether each is scored
  long long (&rate)[4];    // ... their rates
  int (&ref)[2];           // the clamped best vector
  int& pick;               // the diamond step's site
  int& sites;              // diamond sites evaluated
  int& taps;               // six-tap taps of the sites (and, after the
                           // caller's decision, of the candidates scored)
  long long (&red)[8][8];  // per-warp partial sums
};

// Declares the shared arrays of the decision state and ``d``, over them
// and the caller's (8, 8) long long reduction array ``red``.
#define DECIDE_SHARED(d, red)                                            \
  __shared__ int d##_nb[3][3], d##_mv[4][2], d##_en[4], d##_ref[2],      \
      d##_pick, d##_sites, d##_taps;                                     \
  __shared__ long long d##_rate[4];                                      \
  DecideShared d{d##_nb,  d##_mv,    d##_en,   d##_rate, d##_ref,        \
                 d##_pick, d##_sites, d##_taps, red}

// Thread k (0..8) of the caller's choice loads word k of the census: the
// is_inter flag (word ``w_inter``) or a vector component (words ``w_mv``,
// ``w_mv`` + 1) of the above (k / 3 == 0), left (1) or above-left (2)
// macroblock from its decision words (``stride`` ints a macroblock), 0 off
// the frame.  Thread k == 9 zeroes the counts.  Unpublished.
__device__ __forceinline__ void census_load(DecideShared& d, const int* words,
                                            int stride, int w_inter, int w_mv,
                                            int r, int c, int C, int k) {
  if (k < 9) {
    const int n = k / 3, w = k % 3;
    const int nr = n == 1 ? r : r - 1, nc = n == 0 ? c : c - 1;
    const bool valid = n == 0 ? r > 0 : n == 1 ? c > 0 : (r > 0 && c > 0);
    d.nb[n][w] = valid ? words[(size_t)(nr * C + nc) * stride
                               + (w == 0 ? w_inter : w_mv + w - 1)] : 0;
  } else if (k == 9) {
    d.sites = 0;
    d.taps = 0;
  }
}

// Thread 0 only (decoder/parse.py:mv_census and Scorer::calculate,
// macroblock.cc:156-172): the clamped best vector, the four candidates'
// vectors, whether each is scored (ZERO always, NEAREST and NEAR where their
// clamped vector is not zero, NEW left to the search) and their mv_ref
// rates (no SPLITMV neighbours: count 3 is 0).  Unpublished.
__device__ __forceinline__ void census_decide(DecideShared& d, int r, int c,
                                              int R, int C, const int* mvc2p,
                                              const int* pc) {
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
  const int p0 = mvc2p[sc4[0] * 4], p1 = mvc2p[sc4[1] * 4 + 1];
  const int p2 = mvc2p[sc4[2] * 4 + 2], p3 = mvc2p[3];
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
// clamped best vector (published) for this thread's pixel ``o`` = original
// (Y, X) of the macroblock (r, c), SAD plus the SAD mv cost; when
// ``do_search`` is false it does nothing.  Then thread 0 sets candidate
// NEW: the search's vector plus the best one, not clamped again, scored
// where the search ran and the vector is not zero, its rate plus the mv
// cost.  Unpublished.
__device__ __forceinline__ void diamond_search(
    DecideShared& d, bool do_search, int o, const uint8_t* __restrict__ ly,
    int H, int W, int Y, int X, int r, int c, int R, int C,
    const int* sadcost, int sadw, const int* mvcost) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int brx = d.ref[0], bry = d.ref[1];
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
            sad[k] = abs(o - sixtap_pixel(ly, H, W, Y, X, tx, ty));
          }
          sad[k] = warp_sum(sad[k]);
          if (lane == 0) d.red[warp][k] = sad[k];
        }
        __syncthreads();
        if (tid == 0) {
          long long best = 0;
          int bk = -1;
          for (int k = 0; k < 5; ++k) {
            const int sx = ox + st * c_dx[k], sy = oy + st * c_dy[k];
            if (abs(sx) > MV_LIMIT || abs(sy) > MV_LIMIT) continue;
            ++d.sites;
            int tx = sx + brx, ty = sy + bry;
            clamp_mv(tx, ty, r, c, R, C);
            d.taps += luma_taps(tx & 7, ty & 7);
            long long dist = 0;
            for (int w = 0; w < 8; ++w) dist += d.red[w][k];
            const int cx = abs(clampi(sx >> 2, -255, 255));
            const int cy = abs(clampi(sy >> 2, -255, 255));
            const long long rate =
                ((long long)(sadcost[cy] + sadcost[cx]) * sadw + 128) >> 8;
            const long long cost = ((128 + rate) >> 8) + dist;
            if (bk < 0 || cost < best) { best = cost; bk = k; }
          }
          d.pick = bk;
        }
        __syncthreads();
        const int bk = d.pick;
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
    const int fx = smx + brx, fy = smy + bry;
    d.mv[3][0] = fx;
    d.mv[3][1] = fy;
    d.en[3] = do_search && (fx != 0 || fy != 0);
    const long long mvrate = (long long)mvcost[(smy < 0) * 1024 + abs(smy)] +
                             mvcost[(2 + (smx < 0)) * 1024 + abs(smx)];
    d.rate[3] += mvrate * 96 / 128;
  }
}

// The per-warp sums of this thread's difference from each candidate's
// prediction (d.red[w][k]) and of its square (d.red[w][4 + k]), zero for a
// candidate not scored (the candidates published).  Unpublished.
__device__ __forceinline__ void candidate_sums(DecideShared& d, int o,
                                               const uint8_t* __restrict__ ly,
                                               int H, int W, int Y, int X) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long acc[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int diff = 0;
    if (d.en[k]) diff = o - sixtap_pixel(ly, H, W, Y, X, d.mv[k][0], d.mv[k][1]);
    acc[k] = diff;
    acc[4 + k] = diff * diff;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    for (int w = 16; w; w >>= 1) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], w);
    if (lane == 0) d.red[warp][k] = acc[k];
  }
}

struct DecideArgs {
  const uint8_t *oy, *ly;  // original and LAST luma (16R,16C)
  const int* scalars;      // (Q,N_SCALARS)
  const int* icost;        // (Q,R*C) intra cost of each macroblock
  const int* mvc2p;        // MV_COUNTS_TO_PROBS (6,4)
  const int* pcost;        // PROB_COST (256)
  const int* sadcost;      // SAD mv costs (256)
  const int* mvcost;       // mv component costs (4,1024)
  int* md;                 // (Q,R,C,DECIDE_WORDS)
  int R, C;
};

// candidate k's mode: ZEROMV, NEARESTMV, NEARMV, NEWMV
__constant__ int c_decide_mode[4] = {7, 5, 6, 8};

// One block per (macroblock of diagonal d, quantizer blockIdx.y):
// r = r_lo + blockIdx.x, c = d - r.
__global__ void __launch_bounds__(256) enc_decide_diag_kernel(DecideArgs a,
                                                              int d,
                                                              int r_lo) {
  const int r = r_lo + blockIdx.x, c = d - r, qp = blockIdx.y;
  const int tid = threadIdx.x;
  const int R = a.R, C = a.C, H = R * 16, W = C * 16;
  const size_t n_mb = (size_t)R * C;
  const int* sc = a.scalars + qp * N_SCALARS;
  const int rm = sc[6], dm = sc[7], sadw = sc[8];
  int* md = a.md + qp * n_mb * DECIDE_WORDS;
  const int mb = r * C + c;
  const int Y = r * 16 + (tid >> 4), X = c * 16 + (tid & 15);

  __shared__ long long s_red[8][8];
  DECIDE_SHARED(dd, s_red);

  if (tid < 10) census_load(dd, md, DECIDE_WORDS, 0, 2, r, c, C, tid);
  const int o = a.oy[(size_t)Y * W + X];
  __syncthreads();
  if (tid == 0) census_decide(dd, r, c, R, C, a.mvc2p, a.pcost);
  __syncthreads();
  const bool do_search = (r & 3) == 0 && (c & 3) == 0;
  diamond_search(dd, do_search, o, a.ly, H, W, Y, X, r, c, R, C, a.sadcost,
                 sadw, a.mvcost);
  __syncthreads();
  candidate_sums(dd, o, a.ly, H, W, Y, X);
  __syncthreads();
  if (tid == 0) {
    int best = a.icost[qp * n_mb + mb], win = -1, cands = 0;
    for (int k = 0; k < 4; ++k) {
      int cost = DECIDE_INF;
      if (dd.en[k]) {
        ++cands;
        dd.taps += luma_taps(dd.mv[k][0] & 7, dd.mv[k][1] & 7);
        long long sm = 0, sse = 0;
        for (int w = 0; w < 8; ++w) { sm += dd.red[w][k]; sse += dd.red[w][4 + k]; }
        const int var = (int)(sse - sm * sm / 256);
        cost = ((128 + (int)dd.rate[k] * rm) >> 8) + var * dm;
      }
      if (cost < best) { best = cost; win = k; }
    }
    int* w = md + (size_t)mb * DECIDE_WORDS;
    const bool scored = win >= 0 && dd.en[win];
    w[0] = win >= 0;
    w[1] = win >= 0 ? c_decide_mode[win] : 0;
    w[2] = scored ? dd.mv[win][0] : 0;
    w[3] = scored ? dd.mv[win][1] : 0;
    w[4] = dd.sites;
    w[5] = cands;
    w[6] = dd.taps;
    w[7] = 0;
  }
}

// Enqueue the R + C - 1 diagonal launches of one frame at Q quantizers on
// ``stream`` (grid: the diagonal's macroblocks x Q); writes the number of
// kernel launches issued to ``*n_launched`` and returns cudaGetLastError()
// after the last one.
extern "C" int decide_inter_frame_launch(
    const void* oy, const void* ly, const void* scalars, const void* icost,
    const void* mvc2p, const void* pcost, const void* sadcost,
    const void* mvcost, void* md, int Q, int R, int C, void* stream,
    int* n_launched) {
  DecideArgs a;
  a.oy = (const uint8_t*)oy;
  a.ly = (const uint8_t*)ly;
  a.scalars = (const int*)scalars;
  a.icost = (const int*)icost;
  a.mvc2p = (const int*)mvc2p;
  a.pcost = (const int*)pcost;
  a.sadcost = (const int*)sadcost;
  a.mvcost = (const int*)mvcost;
  a.md = (int*)md;
  a.R = R;
  a.C = C;
  cudaStream_t st = (cudaStream_t)stream;
  int issued = 0;
  for (int d = 0; d < R + C - 1; ++d) {
    const int r_lo = d - C + 1 > 0 ? d - C + 1 : 0;
    const int r_hi = d < R - 1 ? d : R - 1;
    enc_decide_diag_kernel<<<dim3(r_hi - r_lo + 1, Q), 256, 0, st>>>(a, d,
                                                                      r_lo);
    ++issued;
  }
  *n_launched = issued;
  return (int)cudaGetLastError();
}
