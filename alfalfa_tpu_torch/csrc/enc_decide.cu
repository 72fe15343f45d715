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
// tie-break (enc_inter_chain.cuh), the int32 costs with INF = 1 << 30 (a
// candidate not scored costs INF and wins over an intra cost above it), the
// vector (0, 0) of a candidate not scored.  Not kept: the raster walk with
// its two-row ring of committed decisions, the phase-split source layout,
// the byte-packed padded reference with its aligned window loads (reads
// clamp per index to the plane, which equals the padding), and the vmap
// over quantizers (here a block's ticket, with one intra cost row each).
//
// Bound: on paper operations (the six-tap taps of every scored vector, and
// the SAD and variance terms) or the bytes of the two luma planes; in
// practice the critical path: every macroblock reads its left, above and
// above-left neighbours' decisions, and a path through the frame can meet
// a searching macroblock every fourth column and row (31 at 720p), each a
// chain of dependent diamond steps.
//
// Design: the decide-only instantiation of K8's decision chain
// (enc_inter_chain.cuh: census, diamond search with one barrier a step and
// the pick taken in every warp, candidates by the TPU kernel's int32
// costs), in one launch per call, persistent (row_sched.cuh): a block of
// 256 threads takes a (row, quantizer) ticket and walks the row left to
// right, waiting before (r, c) for row r-1 to have published min(c + 1, C)
// macroblocks (ROW_LAG in ops/enc_decide_cuda.py).  A thread per luma pixel
// filters its own prediction for every diamond site and candidate; the
// census and the decision words are thread 0's, which also publishes.
// While thread 0 waits, a warp copies the next macroblock's original luma
// into shared memory (cp.async); the cost tables are staged once per block.

#include <cuda_runtime.h>
#include <stdint.h>

#include "enc_inter_chain.cuh"  // the decision chain K9 shares with K8
#include "row_sched.cuh"        // the persistent row walk K9 shares with K8

#define DECIDE_WORDS 8  // is_inter, mode, mvx, mvy, diamond sites evaluated,
                        // candidates scored, six-tap taps of their luma
                        // predictions, 0
#define N_SCALARS 9     // y_dc, y_ac, y2_dc, y2_ac, uv_dc, uv_ac, rate and
                        // distortion multipliers, SAD per bit

struct DecideArgs {
  const uint8_t *oy, *ly;  // original and LAST luma (16R,16C)
  const int* scalars;      // (Q,N_SCALARS)
  const int* icost;        // (Q,R*C) intra cost of each macroblock
  ChainTables t;           // the decision chain's cost tables
  int* md;                 // (Q,R,C,DECIDE_WORDS)
  int Q, R, C;
  RowSched rs;
};

// K9's costs: the TPU kernel's int32 arithmetic; a candidate not scored
// costs INF (no scored cost reaches 2^31: variance <= 256 * 255^2 times a
// distortion multiplier <= 100, plus a rate under 2^24).
struct Int32InfCosts {
  typedef int T;
  static constexpr int kUnscored = 1 << 30;
  static __device__ __forceinline__ T cost(long long rate, long long var,
                                           int rm, int dm) {
    return ((128 + (int)rate * rm) >> 8) + (int)var * dm;
  }
};

// One block per (row, quantizer) ticket; R * Q blocks.
__global__ void __launch_bounds__(256) enc_decide_row_kernel(DecideArgs a) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  CHAIN_SHARED(d);
  __shared__ __align__(16) uint8_t s_src[2][256];  // original luma, by parity
  __shared__ int s_ticket;

  chain_stage_tables(d, a.t);
  if (tid == 0) s_ticket = atomicAdd(a.rs.ticket, 1);
  __syncthreads();
  const int Q = a.Q, R = a.R, C = a.C, H = R * 16, W = C * 16;
  const int r = s_ticket / Q, qp = s_ticket % Q;
  const size_t n_mb = (size_t)R * C;
  const int* sc = a.scalars + qp * N_SCALARS;
  const int rm = sc[6], dm = sc[7], sadw = sc[8];
  int* md = a.md + qp * n_mb * DECIDE_WORDS;
  const int* icost = a.icost + qp * n_mb;
  int* prog = a.rs.progress + qp * R + r;
  const int lag = a.rs.lag;
  const int Y = r * 16 + (tid >> 4);
  const bool search_row = (r & 3) == 0;

  if (warp == 2) stage_originals(s_src[0], a.oy, 0, 0, r, 0, C, lane, false);
  cp_async_commit();
  for (int c = 0; c < C; ++c) {
    // the next macroblock's original, while thread 0 waits on the row above
    if (warp == 2 && c + 1 < C)
      stage_originals(s_src[(c + 1) & 1], a.oy, 0, 0, r, c + 1, C, lane,
                      false);
    cp_async_commit();
    const int mb = r * C + c, X = c * 16 + (tid & 15);
    if (tid == 0) {
      if (r > 0) row_wait(prog - 1, min(c + lag, C));
      for (int k = 0; k < 9; ++k)
        census_load(d, md, DECIDE_WORDS, 0, 2, r, c, C, k);
      census_decide(d, r, c, R, C);
    }
    cp_async_wait<1>();
    __syncthreads();                // the census, the original
    const int o = s_src[c & 1][tid];
    const int brx = d.ref[0], bry = d.ref[1];
    const bool do_search = search_row && (c & 3) == 0;
    int smx = 0, smy = 0, sites = 0, taps = 0, cands = 0;
    if (do_search)
      diamond_search(d, o, a.ly, H, W, Y, X, r, c, R, C, sadw, brx, bry, smx,
                     smy, sites, taps);
    // the search's vector plus the best one, not clamped again
    const int nx = smx + brx, ny = smy + bry;
    const bool en_new = do_search && (nx != 0 || ny != 0);
    candidate_sums(d, o, a.ly, H, W, Y, X, nx, ny, en_new);
    __syncthreads();
    const int win = decide_candidates<Int32InfCosts>(
        d, icost[mb], rm, dm, nx, ny, en_new, new_rate(d, smx, smy), cands,
        taps);
    if (tid == 0) {
      const bool scored = win >= 0 && (win < 3 ? d.en[win] != 0 : en_new);
      int* w = md + (size_t)mb * DECIDE_WORDS;
      w[0] = win >= 0;
      w[1] = win >= 0 ? c_inter_mode[win] : 0;
      w[2] = scored ? (win < 3 ? d.mv[win][0] : nx) : 0;
      w[3] = scored ? (win < 3 ? d.mv[win][1] : ny) : 0;
      w[4] = sites;
      w[5] = cands;
      w[6] = taps;
      w[7] = 0;
      row_publish(prog, c + 1);     // thread 0 wrote every output itself
    }
    __syncthreads();                // the chain state is free again
  }
}

// Launch the persistent kernel for one frame at Q quantizers on ``stream``:
// R * Q blocks, one launch; ``sched`` is 1 + Q * R zeroed ints (the ticket,
// then the rows' progress), ``lag`` the wait rule's lag (1).  Writes the
// number of kernel launches issued (1) to ``*n_launched`` and returns
// cudaGetLastError() after it.
extern "C" int decide_inter_frame_launch(
    const void* oy, const void* ly, const void* scalars, const void* icost,
    const void* mvc2p, const void* pcost, const void* sadcost,
    const void* mvcost, void* md, int Q, int R, int C, void* sched, int lag,
    void* stream, int* n_launched) {
  DecideArgs a;
  a.oy = (const uint8_t*)oy;
  a.ly = (const uint8_t*)ly;
  a.scalars = (const int*)scalars;
  a.icost = (const int*)icost;
  a.t.mvc2p = (const int*)mvc2p;
  a.t.pcost = (const int*)pcost;
  a.t.sadcost = (const int*)sadcost;
  a.t.mvcost = (const int*)mvcost;
  a.md = (int*)md;
  a.Q = Q;
  a.R = R;
  a.C = C;
  a.rs.ticket = (int*)sched;
  a.rs.progress = (int*)sched + 1;
  a.rs.lag = lag;
  enc_decide_row_kernel<<<R * Q, 256, 0, (cudaStream_t)stream>>>(a);
  *n_launched = 1;
  return (int)cudaGetLastError();
}

// Blocks of the kernel the card ``device`` holds at once: blocks per SM at
// 256 threads times the SMs (0 on an error).
extern "C" int decide_inter_frame_resident(int device) {
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, enc_decide_row_kernel, 256, 0) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return 0;
  return per_sm * sms;
}
