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
// tie-break (enc_inter_chain.cuh), the search's bounds test and clamps.
// Not kept: the serial raster walk (the TPU runs one macroblock at a time
// because its scalar unit drives the window loads), the byte-packed padded
// references and their aligned window loads (reads clamp per index to the
// plane, which equals the padding of 32 >= 21 pixels), the phase-split
// layouts and permutation matmuls, the vmap over quantizers and the int32
// costs with INF = 1 << 30 (int64 here, as the host loop's Python ints: the
// two could part only where a cost reaches 2^30).
//
// Bound: on paper operations (each diamond site filters 256 pixels at about
// 100 integer operations each, and a macroblock scores tens of sites); in
// practice the critical path through the macroblocks' dependences: every
// read of macroblock (r, c) is of (r, c-1) or of row r-1 up to column c+1,
// and a macroblock's search is a chain of dependent diamond steps, the
// intra macroblocks K7's B_PRED chain of 10 dependent steps.
//
// Design: one launch per call, persistent (row_sched.cuh).  A block of 256
// threads takes a (row, quantizer) ticket and walks the row left to right,
// waiting before (r, c) for row r-1 to have published min(c + 2, C)
// macroblocks (ROW_LAG in ops/enc_inter_cuda.py) and publishing each
// macroblock when its outputs are written.  So no macroblock waits for a
// diagonal's slowest one, and there are no launch gaps.  While thread 0
// waits, a warp copies the next macroblock's originals into shared memory
// (cp.async).  The cost tables are staged in shared memory once per block.
// Each thread owns one luma pixel: it filters its own prediction for every
// candidate vector straight from the reference (sixtap_device.cuh, the
// decoders' filter) and a block reduction gives SAD or variance.  The
// decision chain (census, diamond search, candidates) is
// enc_inter_chain.cuh, shared with K9: one barrier a diamond step, each
// warp taking the step's pick itself.  The intra macroblock code is K7's
// (enc_mb_device.cuh:intra_mb): after the whole-mode screening, B_PRED with
// reconstruction in the loop under the interframe's non-contextual b-mode
// costs on warp 0, beside the whole-mode Y2 path and chroma on warps 1-7.
// Neighbour state in device memory: the unfiltered reconstruction, the
// mode words (census) and, two-pass, the per-4x4 nonzero flags and Y2
// chains (inter macroblocks write zero flags and pass the chains on).

#include <cuda_runtime.h>
#include <stdint.h>

#include "enc_inter_chain.cuh"  // the decision chain K8 shares with K9
#include "enc_mb_device.cuh"    // the macroblock steps K8 shares with K7
#include "row_sched.cuh"        // the persistent row walk K8 shares with K9

#define MODE_WORDS 32  // ymode, uvmode, is_inter, has_nonzero, mvx, mvy,
                       // chroma mvx, mvy, 16 b-modes, diamond sites
                       // evaluated, candidates scored, six-tap taps their
                       // luma predictions need, 5 zero
#define SITES 24
#define CANDS 25
#define TAPS 26
#define N_SCALARS 9    // y_dc, y_ac, y2_dc, y2_ac, uv_dc, uv_ac, rate and
                       // distortion multipliers, SAD per bit

struct InterArgs {
  MbPlanes p;                   // quantizer 0's planes and state; a block
                                // offsets them by its ticket's quantizer
  const uint8_t *ly, *lu, *lv;  // the LAST reference (16R,16C), (8R,8C)
  int16_t* coeffs;              // (Q,R,C,25,16) raster order
  int* modes;                   // (Q,R,C,MODE_WORDS)
  const int* scalars;           // (Q,N_SCALARS)
  const int* mbc;               // interframe macroblock mode costs (5)
  const int* ibc;               // interframe b-mode costs (10)
  ChainTables t;                // the decision chain's cost tables
  int realtime;                 // NEWMV only where row, column % 4 == 0
  int Q;
  RowSched rs;
};

// (4v + 4) >> 3, rounded symmetrically about zero
__device__ __forceinline__ int chroma_mv(int v) {
  return v > 0 ? (4 * v + 4) >> 3 : v < 0 ? -((-4 * v + 4) >> 3) : 0;
}

// K8's costs: int64, as the host loop's; a candidate not scored never wins.
struct Int64Costs {
  typedef long long T;
  static constexpr long long kUnscored = 0x7fffffffffffffffll;
  static __device__ __forceinline__ T cost(long long rate, long long var,
                                           int rm, int dm) {
    return rdcost(rate, var, rm, dm);
  }
};

// One block per (row, quantizer) ticket; R * Q blocks.
__global__ void __launch_bounds__(256) enc_inter_row_kernel(InterArgs a) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  MB_SHARED(s);
  CHAIN_SHARED(d);
  __shared__ int s_mbc[5], s_ibc[10];
  __shared__ __align__(16) uint8_t s_src[2][384];  // originals, by parity
  __shared__ int s_ticket;

  chain_stage_tables(d, a.t);
  if (tid < 5) s_mbc[tid] = a.mbc[tid];
  else if (tid >= 32 && tid < 42) s_ibc[tid - 32] = a.ibc[tid - 32];
  if (tid == 0) s_ticket = atomicAdd(a.rs.ticket, 1);
  __syncthreads();
  const int Q = a.Q, r = s_ticket / Q, qp = s_ticket % Q;
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
  int* prog = a.rs.progress + qp * R + r;
  const int lag = a.rs.lag;
  const int py = tid >> 4, px = tid & 15, Y = r * 16 + py;

  if (warp == 2) stage_originals(s_src[0], P.oy, P.ou, P.ov, r, 0, C, lane, true);
  cp_async_commit();
  for (int c = 0; c < C; ++c) {
    // the next macroblock's originals, while thread 0 waits on the row above
    if (warp == 2 && c + 1 < C)
      stage_originals(s_src[(c + 1) & 1], P.oy, P.ou, P.ov, r, c + 1, C, lane,
                      true);
    cp_async_commit();
    if (tid == 0 && r > 0) row_wait(prog - 1, min(c + lag, C));
    cp_async_wait<1>();
    __syncthreads();
    const int X = c * 16 + px, mb = r * C + c;

    // the census's neighbour words (the barrier in mb_load publishes them)
    if (tid >= 180 && tid < 189)
      census_load(d, modes, MODE_WORDS, 2, 4, r, c, C, tid - 180);
    mb_load(P, s, r, c, s_src[c & 1]);
    if (tid == 96) census_decide(d, r, c, R, C);
    __syncthreads();                // the DC values, the census
    whole_luma_costs(P, s, s_mbc);  // intra screening: s.wcost

    // ---- NEWMV, then the four candidates by variance rd-cost ----
    const int o = s.o[tid];
    const int brx = d.ref[0], bry = d.ref[1];
    const bool do_search = !a.realtime || ((r & 3) == 0 && (c & 3) == 0);
    int smx = 0, smy = 0, sites = 0, taps = 0, cands = 0;
    if (do_search)
      diamond_search(d, o, a.ly, H, W, Y, X, r, c, R, C, sadw, brx, bry, smx,
                     smy, sites, taps);
    // the search's vector plus the best one, not clamped again
    const int nx = smx + brx, ny = smy + bry;
    const bool en_new = do_search && (nx != 0 || ny != 0);
    candidate_sums(d, o, a.ly, H, W, Y, X, nx, ny, en_new);
    __syncthreads();
    const int win = decide_candidates<Int64Costs>(
        d, s.wcost, P.rm, P.dm, nx, ny, en_new, new_rate(d, smx, smy), cands,
        taps);

    // ---- encode the winner ----
    const bool inter = win >= 0;
    bool use_b = false;
    int mvx = 0, mvy = 0, cmx = 0, cmy = 0;
    if (inter) {
      mvx = win < 3 ? d.mv[win][0] : nx;
      mvy = win < 3 ? d.mv[win][1] : ny;
      cmx = chroma_mv(mvx);
      cmy = chroma_mv(mvy);
      s.p16[tid] = sixtap_pred(a.ly, H, W, Y, X, mvx, mvy);
      if (tid < 128) {
        const int pl = tid >> 6, k = tid & 63;
        s.pc[pl][k] = sixtap_pred(pl ? a.lv : a.lu, H / 2, W / 2,
                                  r * 8 + (k >> 3), c * 8 + (k & 7), cmx, cmy);
      }
      __syncthreads();
      y2_path(P, s, false, TilePred{});   // inter macroblocks: no trellis
      chroma_code(P, s, r, c, false, TilePred{});
    } else {
      use_b = intra_mb(P, s, r, c, s_mbc, s_ibc, false, P.tc != nullptr,
                       true);
    }
    const int wm = s.dec[0], um = s.dec[1];

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
    P.ry[(size_t)Y * W + X] =
        (uint8_t)(inter || use_b ? s.t[1 + py][1 + px] : s.wt[py][px]);
    const int has_nonzero = __syncthreads_or(any);
    int* md = modes + (size_t)mb * MODE_WORDS;
    if (tid < 16) {
      md[8 + tid] = inter ? 0 : use_b ? s.bm[tid] : imode_to_bmode(wm);
    } else if (tid == 16) {
      md[0] = inter ? c_inter_mode[win] : use_b ? B_PRED : wm;
      md[1] = inter ? 0 : um;
      md[2] = inter;
      md[3] = has_nonzero != 0;
      md[4] = mvx;
      md[5] = mvy;
      md[6] = cmx;
      md[7] = cmy;
    } else if (tid >= SITES && tid < MODE_WORDS) {
      md[tid] = tid == SITES ? sites : tid == CANDS ? cands
                : tid == TAPS ? taps : 0;
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
    __syncthreads();                // every output of (r, c) written
    if (tid == 0) row_publish(prog, c + 1);
  }
}

// Launch the persistent kernel for one frame at Q quantizers on ``stream``:
// R * Q blocks, one launch; ``sched`` is 1 + Q * R zeroed ints (the ticket,
// then the rows' progress), ``lag`` the wait rule's lag (2).  Writes the
// number of kernel launches issued (1) to ``*n_launched`` and returns
// cudaGetLastError() after it.  ``tc`` null: plain quantization (then vcost
// and the flag buffers are not read).
extern "C" int encode_inter_frame_launch(
    const void* oy, const void* ou, const void* ov, const void* ly,
    const void* lu, const void* lv, void* ry, void* ru, void* rv,
    void* coeffs, void* modes, const void* scalars, const void* mbc,
    const void* ibc, const void* mvc2p, const void* pcost,
    const void* sadcost, const void* mvcost, const void* tc,
    const void* vcost, void* ynz, void* unz, void* vnz, void* y2c,
    int realtime, int Q, int R, int C, void* sched, int lag, void* stream,
    int* n_launched) {
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
  a.t.mvc2p = (const int*)mvc2p;
  a.t.pcost = (const int*)pcost;
  a.t.sadcost = (const int*)sadcost;
  a.t.mvcost = (const int*)mvcost;
  a.realtime = realtime;
  a.Q = Q;
  a.rs.ticket = (int*)sched;
  a.rs.progress = (int*)sched + 1;
  a.rs.lag = lag;
  enc_inter_row_kernel<<<R * Q, 256, 0, (cudaStream_t)stream>>>(a);
  *n_launched = 1;
  return (int)cudaGetLastError();
}

// Blocks of the kernel the card ``device`` holds at once: blocks per SM at
// 256 threads times the SMs (0 on an error).
extern "C" int encode_inter_frame_resident(int device) {
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, enc_inter_row_kernel, 256, 0) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return 0;
  return per_sm * sms;
}
