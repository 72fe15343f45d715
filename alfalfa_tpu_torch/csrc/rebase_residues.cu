// rebase_frame: the rebase's residue update of one frame in one launch:
// K3's six-tap prediction and the residues of the inter macroblocks, and
// the intra macroblocks with their given modes, as one persistent row walk.
//
// Replaces no pallas_call: the JAX package computes the inter half with
// XLA (alfalfa_tpu/encoder/reencode_device.py:_fn_core, H1's helpers of
// alfalfa_tpu/ops/enc_transforms_pallas.py around K3,
// ops/sixtap_pallas.py:mc_tiles) and the intra macroblocks in a host loop
// (alfalfa_tpu/encoder/reencode.py:_apply_intra_mb).  The port had K3,
// then a residue kernel of a block a macroblock for the inter ones, then
// the intra ones on host copies of the planes; this kernel does all three
// on the card.  Plain version ops/rebase.py:rebase_frame_plain; wrapper
// ops/rebase_cuda.py.
//
// Semantics (reference reencode.cc:131-230), the prediction frame's modes
// and vectors kept:
// - an inter macroblock (ref != 0): the six-tap prediction of its three
//   planes from its reference slot at its vectors (whole or SPLITMV; K3's
//   edge and filter rules, sixtap_device.cuh), the original minus it
//   through the forward DCT and truncating quantization, a whole-vector
//   macroblock's 16 luma DCs through the forward WHT into Y2 (its luma
//   blocks code AC only; SPLITMV keeps them in-block and codes Y2 as
//   zeros), then the decoder's reconstruction (dequantize, inverse WHT
//   into the luma DCs, inverse DCT, add, clamp) into the planes;
// - an intra macroblock (ref == 0), from the final reconstruction of its
//   neighbours with the 127 / 129 edge rules: a whole luma mode through
//   the Y2 chain, or B_PRED as 16 sub-blocks each predicted with its
//   b-mode from what the ones before it reconstructed (the right-most
//   column's above-right from the row above the macroblock; no Y2), then
//   chroma in the given chroma mode.
// Out: a macroblock's 400 coefficients (16 luma blocks, 4 U, 4 V, Y2) and
// a flag word (bit 0 any coefficient nonzero, bit 1 Y2 coded), every
// macroblock; the unfiltered reconstruction, written whole.
//
// Design: K10's walk (enc_intra_fixup.cu) with K3 and the inter residues
// folded in, persistent (row_sched.cuh): max(R, the blocks the card holds)
// blocks of 256 threads.  Every block first takes pair tickets: pair t is
// macroblocks 2t and 2t + 1 in raster order, of which it does the inter
// ones (they read only the references, so nothing waits): their 48 4x4
// blocks on the block's 16 half-warps in three passes, lane p of a
// half-warp on pixel p, the six-tap prediction straight into registers
// (K8's sixtap_pred: a zero phase's pass skipped, one load a full-pel
// pixel), then H1's lane forms (fdct4x4_lane, quantize_lane, then
// dequantize_lane, idct4x4_lane); the luma DCs through shared memory to
// threads 0 and 32, one a macroblock, for the WHT chain (its quantizer a
// reciprocal multiply, as quantize_lane's); two barriers a pair.  Nothing goes to device memory but the coefficients and the
// reconstruction.  Each finished macroblock counts one in its row's
// inter count (a release, at the next barrier).  So the frame's inter
// work is spread over the whole card, not over its R row walkers.  When
// the pairs are all taken, a block takes a row ticket (those left without
// a row return), waits for its row's inter count to reach C (every pair
// was taken by a running block, which waits on nothing), and visits the
// row's intra macroblocks left to right with K7's and K10's steps
// (enc_mb_device.cuh: mb_load, y2_path and chroma_code with the mode
// fixed; B_PRED on warp 0 as bpred_given below, K7's chain of 10
// diagonal steps with the b-modes given, beside chroma_code on warps
// 1-7).  Before (r, c) thread 0 waits for row r-1 to have published
// min(c + lag, C) macroblocks, the lag taken from the macroblock's mode:
// 2 for B_PRED (its right-most sub-blocks read the above-right
// macroblock's bottom row), 1 for a whole mode (left, above and above-left
// only; mb_load's above-right pixels may then be in flight, and whole
// modes never read them).  It publishes once a run of inter macroblocks:
// the column of its first intra macroblock once the row's inter ones are
// final, after each intra macroblock the column of the next (C at the
// end).  Any published value is at least 1 only after the row's inter
// count reached C, so a satisfied wait finds the row above's inter
// macroblocks final.  While thread 0 waits, warp 2 copies the next intra
// macroblock's originals into shared memory (cp.async).
//
// Bound: bytes for a frame of inter macroblocks (the originals, the
// references each referenced pixel once, the words in; coefficients and
// the reconstruction out); with intra macroblocks the critical path, the
// longest chain of intra macroblocks linked left, above, above-left and
// (B_PRED) above-right, each a dozen block barriers and, for B_PRED, the
// 10-step chain of dependent 4x4 transforms.

#include <cuda_runtime.h>
#include <stdint.h>

#include "enc_inter_chain.cuh"  // sixtap_pred: K3's rules, per pixel
#include "enc_mb_device.cuh"    // the macroblock steps of K7, K8, K10
#include "row_sched.cuh"        // the persistent row walk of K1, K4, K5, K7-K10

// a macroblock's words (ops/rebase.py: MB_WORDS and the W_* offsets)
#define MB_WORDS 32
#define W_REF 0
#define W_YMODE 1
#define W_UVMODE 2
#define W_BMODE 4
#define W_MV 8
#define W_UVMV 24
#define OUT_WORDS 401  // 400 coefficients, the flag word
#define SPLITMV 9

struct RebaseArgs {
  MbPlanes p;                // originals, the reconstruction (written
                             // whole), the six quantizer factors
  const uint8_t* ref[3][3];  // [plane][slot]: last, golden, alternate
  const int* words;          // (R, C, MB_WORDS)
  int16_t* out;              // (R, C, OUT_WORDS)
  int lag_whole, lag_bpred;  // the waits of an intra macroblock by mode
  int* pair_ticket;          // the next pair of macroblocks, zero at launch
  int* inter_done;           // (R) macroblocks of each row past the inter
                             // step, zero at launch
  RowSched rs;               // progress (R)
};

// The first column at or after ``c`` (C if none) whose macroblock in the
// row's ``words`` is intra (``intra``) or inter: the calling warp scans 32
// columns at a time, so every warp finds it without a barrier.
__device__ __forceinline__ int next_mb(const int* words, int c, int C,
                                       bool intra) {
  const int lane = threadIdx.x & 31;
  for (int base = c; base < C; base += 32) {
    const int k = base + lane;
    const unsigned m = __ballot_sync(
        0xffffffffu, k < C && (words[(size_t)k * MB_WORDS + W_REF] == 0) == intra);
    if (m) return base + __ffs(m) - 1;
  }
  return C;
}

__device__ __forceinline__ int mv_x(int w) { return (w << 16) >> 16; }
__device__ __forceinline__ int mv_y(int w) { return w >> 16; }

// Release ``n`` more macroblocks of row ``r`` whose inter work is done
// (thread 0, after a barrier that follows their writes; a release is
// cumulative, as row_publish's).
__device__ __forceinline__ void inter_release(int* done, int mb, int C) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;" ::"l"(done + mb / C),
               "r"(1) : "memory");
}

// The frame's inter macroblocks, shared out in pairs of macroblocks in
// raster order (2t, 2t + 1 for pair ticket t; an intra one is skipped),
// until every pair is taken; each macroblock of a finished pair counts one
// in its row's ``inter_done``.  Called by all 256 threads.
__device__ __forceinline__ void inter_pairs(const RebaseArgs& a,
                                            const MbPlanes& P) {
  __shared__ int s_dcs[2][16], s_dcrec[2][16], s_nz[2], s_pair;
  const int tid = threadIdx.x, hw = tid >> 4, p = tid & 15, C = P.C;
  const int n_mb = P.R * C, n_pairs = (n_mb + 1) >> 1;
  if (tid < 2) s_nz[tid] = 0;
  if (tid == 0) s_pair = atomicAdd(a.pair_ticket, 1);
  __syncthreads();
  int t = s_pair, done = -1;   // done: the pair not yet counted
  while (t < n_pairs) {
    int pr[3], qv[3];
    // pass k: item k * 16 + hw of the pair's 48 blocks, 24 a macroblock
    // (16 luma, 4 U, 4 V): a warp's two items share a macroblock and a
    // plane
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int item = k * 16 + hw, mi = item >= 24, b = item - 24 * mi;
      const int mb = 2 * t + mi, r = mb / C, col = mb - r * C;
      const int pl = b < 16 ? 0 : b < 20 ? 1 : 2, S = pl ? 8 : 16;
      const int sb = pl ? (b - 16) & 3 : b, nb = S >> 2;
      const int ty = ((sb / nb) << 2) + (p >> 2), tx = ((sb % nb) << 2) + (p & 3);
      const int* w = a.words + (size_t)(mb < n_mb ? mb : 0) * MB_WORDS;
      const bool live = mb < n_mb && w[W_REF] != 0;
      const bool split = w[W_YMODE] == SPLITMV;
      int o = 0, pred = 0;
      if (live) {
        const int slot = clampi(w[W_REF] - 1, 0, 2);
        // the argument arrays indexed with constants only (a computed
        // index would copy them to local memory)
        const uint8_t* ref = a.ref[0][0];
#pragma unroll
        for (int q = 1; q < 9; ++q)
          if (q == pl * 3 + slot) ref = a.ref[q / 3][q % 3];
        const int mv = w[pl ? W_UVMV + sb : W_MV + sb];
        const int y = r * S + ty, x = col * S + tx;
        pred = sixtap_pred(ref, P.R * S, C * S, y, x, mv_x(mv), mv_y(mv));
        o = (pl == 0 ? P.oy : pl == 1 ? P.ou : P.ov)[(size_t)y * (C * S) + x];
      }
      const int co = fdct4x4_lane(o - pred, p);
      if (pl == 0 && p == 0) s_dcs[mi][b] = co;
      const int f = p ? (pl ? P.q[5] : P.q[1]) : (pl ? P.q[4] : P.q[0]);
      // a whole-vector macroblock's luma DC rides Y2
      qv[k] = (pl == 0 && p == 0 && !split) ? 0 : quantize_lane(co, quantize_inv(f));
      pr[k] = pred;
      if (live) {
        a.out[(size_t)mb * OUT_WORDS + b * 16 + p] = (int16_t)qv[k];
        if (qv[k]) s_nz[mi] = 1;
      }
    }
    __syncthreads();
    if (tid == 0 && done >= 0) {   // the previous pair's writes are behind
      inter_release(a.inter_done, 2 * done, C);
      if (2 * done + 1 < n_mb) inter_release(a.inter_done, 2 * done + 1, C);
    }
    if ((tid & 31) == 0 && tid < 64) {   // Y2: thread 0 for 2t, 32 for 2t+1
      const int mi = tid >> 5, mb = 2 * t + mi;
      const int* w = a.words + (size_t)(mb < n_mb ? mb : 0) * MB_WORDS;
      if (mb < n_mb && w[W_REF] != 0) {
        const bool split = w[W_YMODE] == SPLITMV;
        int16_t* o = a.out + (size_t)mb * OUT_WORDS;
        int nz = s_nz[mi];
        s_nz[mi] = 0;
        if (split) {
          for (int i = 0; i < 16; ++i) o[384 + i] = 0;
        } else {
          int y2[16], yq[16], y2d[16];
          fwht4x4(s_dcs[mi], y2);
          const unsigned dc_inv = quantize_inv(P.q[2]);
          const unsigned ac_inv = quantize_inv(P.q[3]);
          for (int i = 0; i < 16; ++i) {
            yq[i] = quantize_lane(y2[i], i ? ac_inv : dc_inv);
            o[384 + i] = (int16_t)yq[i];
            nz |= yq[i] != 0;
          }
          dequantize4x4(yq, P.q[2], P.q[3], y2d);
          iwht4x4(y2d, s_dcrec[mi]);
        }
        o[400] = (int16_t)((nz ? 1 : 0) | (split ? 0 : 2));
      }
    }
    if (tid == 64) s_pair = atomicAdd(a.pair_ticket, 1);  // the next pair
    __syncthreads();
    // the decoder's reconstruction of what was coded
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int item = k * 16 + hw, mi = item >= 24, b = item - 24 * mi;
      const int mb = 2 * t + mi, r = mb / C, col = mb - r * C;
      const int pl = b < 16 ? 0 : b < 20 ? 1 : 2, S = pl ? 8 : 16;
      const int sb = pl ? (b - 16) & 3 : b, nb = S >> 2;
      const int ty = ((sb / nb) << 2) + (p >> 2), tx = ((sb % nb) << 2) + (p & 3);
      const int* w = a.words + (size_t)(mb < n_mb ? mb : 0) * MB_WORDS;
      const bool live = mb < n_mb && w[W_REF] != 0;
      const bool split = !live || w[W_YMODE] == SPLITMV;
      const int f = p ? (pl ? P.q[5] : P.q[1]) : (pl ? P.q[4] : P.q[0]);
      int dq = dequantize_lane(qv[k], f);
      if (pl == 0 && p == 0 && !split) dq = s_dcrec[mi][b];
      const int v = pr[k] + idct4x4_lane(dq, p);
      if (live)
        (pl == 0 ? P.ry : pl == 1 ? P.ru : P.rv)
            [(size_t)(r * S + ty) * (C * S) + col * S + tx] =
                (uint8_t)clampi(v, 0, 255);
    }
    done = t;
    t = s_pair;
  }
  __syncthreads();
  if (tid == 0 && done >= 0) {
    inter_release(a.inter_done, 2 * done, C);
    if (2 * done + 1 < n_mb) inter_release(a.inter_done, 2 * done + 1, C);
  }
}

// The B_PRED luma of the macroblock after mb_load and a barrier, its
// b-modes in s.bm: warp 0's (the other warps return at once).  K7's chain
// (bpred_candidate) with the mode given: the 16 sub-blocks in 10 steps
// along the diagonals 2 sr + sc, a step's one or two sub-blocks on the
// warp's two 16-lane halves, lane p on pixel p; the coefficients into
// s.bco, the reconstruction into the working tile, published by the
// caller's next barrier.
__device__ __forceinline__ void bpred_given(const MbPlanes& a, MbShared& s) {
  const int lane = threadIdx.x;
  if (lane >= 32) return;
  const int p = lane & 15, h = lane >> 4, ly = p >> 2, lx = p & 3;
  const int f = p ? a.q[1] : a.q[0];
  const unsigned inv = quantize_inv(f);
  for (int d = 0; d < 10; ++d) {
    // half h takes the (h+1)-th sub-block of diagonal d, in order of rows
    const int first = d < 3 ? 0 : (d - 2) >> 1;
    const bool active = first + h <= 3 && d - 2 * (first + h) >= 0;
    const int sr = active ? first + h : first, sc = d - 2 * sr;
    const int sb = sr * 4 + sc, y0 = sr * 4, x0 = sc * 4;
    int* E = s.edge[h];
    // E[0..3] the left column bottom-up, E[4] above-left, E[5..12] above
    // and above-right; the right-most sub-block takes its above-right from
    // the row above the macroblock in every sub-block row
    if (p < 4) E[p] = s.t[y0 + 4 - p][x0];
    else if (p < 9) E[p] = s.t[y0][x0 + p - 4];
    else if (p < 13) E[p] = s.t[sc == 3 ? 0 : y0][x0 + p - 4];
    const int o = s.o[(y0 + ly) * 16 + x0 + lx];
    __syncwarp();
    const int pred = bpred_pixel(s.bm[sb], E, ly, lx);
    const int q = quantize_lane(fdct4x4_lane(o - pred, p), inv);
    const int res = idct4x4_lane(dequantize_lane(q, f), p);
    if (active) {
      s.bco[sb][p] = q;
      s.t[y0 + 1 + ly][x0 + 1 + lx] = clampi(pred + res, 0, 255);
    }
    __syncwarp();
  }
}

// Intra macroblock (r, c) with its words ``w``, its originals in
// ``staged``: every output.  Called by all 256 threads; leaves the outputs
// unpublished.
__device__ __forceinline__ void intra_mb_given(const MbPlanes& P, MbShared& s,
                                               int16_t* out, const int* w,
                                               int r, int c,
                                               const uint8_t* staged) {
  const int tid = threadIdx.x, W = P.C * 16;
  const int ymode = w[W_YMODE], uvmode = w[W_UVMODE];
  const bool bpred = ymode == B_PRED;
  // threads 128-143 are free before mb_load, whose barrier publishes this
  if (tid >= 128 && tid < 144) {
    const int i = tid - 128;
    s.bm[i] = (w[W_BMODE + (i >> 2)] >> (8 * (i & 3))) & 255;
  }
  mb_load(P, s, r, c, staged);
  __syncthreads();                                   // the DC values
  if (bpred) {
    if (tid < 32)
      bpred_given(P, s);
    else
      chroma_code<WholePred, SideTeam>(P, s, r, c, false, WholePred{uvmode});
  } else {
    y2_path(P, s, false, WholePred{ymode});
    chroma_code(P, s, r, c, false, WholePred{uvmode});
  }
  __syncthreads();

  int any = 0;
  for (int i = tid; i < 400; i += 256) {
    const int blk = i >> 4, p = i & 15;
    const int v = blk < 16 ? (bpred ? s.bco[blk][p] : s.wco[blk][p])
                  : blk < 24 ? s.uvco[blk - 16][p]
                             : (bpred ? 0 : s.y2[p]);
    out[i] = (int16_t)v;
    any |= v != 0;
  }
  const int py = tid >> 4, px = tid & 15;
  P.ry[(size_t)(r * 16 + py) * W + c * 16 + px] = (uint8_t)s.t[1 + py][1 + px];
  const int nz = __syncthreads_or(any);
  if (tid == 0) out[400] = (int16_t)((nz ? 1 : 0) | (bpred ? 0 : 2));
}

// Every block first takes pair tickets until the frame's inter
// macroblocks are all taken, then a row ticket (blocks left without a row
// return); max(R, the blocks the card holds) blocks.
__global__ void __launch_bounds__(256) rebase_row_kernel(RebaseArgs a) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  MB_SHARED(s);
  __shared__ __align__(16) uint8_t s_src[2][384];  // originals, by parity
  __shared__ int s_ticket;
  // a copy, not a reference: its fields stay in registers
  const MbPlanes P = a.p;
  const int C = P.C;
  inter_pairs(a, P);

  if (tid == 0) s_ticket = atomicAdd(a.rs.ticket, 1);
  __syncthreads();
  const int r = s_ticket;
  if (r >= P.R) return;
  const int* words = a.words + (size_t)r * C * MB_WORDS;
  int16_t* out = a.out + (size_t)r * C * OUT_WORDS;
  int* prog = a.rs.progress + r;
  // the row's inter macroblocks final: every pair that holds one was
  // taken before this ticket, by a block that is running
  if (tid == 0) row_wait(a.inter_done + r, C);

  int c = next_mb(words, 0, C, true);
  __syncthreads();                  // the inter macroblocks final
  if (tid == 0) row_publish(prog, c);
  if (warp == 2 && c < C)
    stage_originals(s_src[0], P.oy, P.ou, P.ov, r, c, C, lane, true);
  cp_async_commit();
  for (int k = 0; c < C; ++k) {
    const int nxt = next_mb(words, c + 1, C, true);
    // the next intra macroblock's originals, while thread 0 waits
    if (warp == 2 && nxt < C)
      stage_originals(s_src[(k + 1) & 1], P.oy, P.ou, P.ov, r, nxt, C, lane,
                      true);
    cp_async_commit();
    const int* w = words + (size_t)c * MB_WORDS;
    if (tid == 0 && r > 0)
      row_wait(prog - 1, min(c + (w[W_YMODE] == B_PRED ? a.lag_bpred
                                                       : a.lag_whole), C));
    cp_async_wait<1>();
    __syncthreads();
    intra_mb_given(P, s, out + (size_t)c * OUT_WORDS, w, r, c, s_src[k & 1]);
    __syncthreads();                // every output of (r, c) written
    if (tid == 0) row_publish(prog, nxt);
    c = nxt;
  }
}

// p: the parameter words: orig[3], recon[3], ref[3][3] (plane-major),
// words, out, then the six quantizer factors.  ``sched`` is 2 + 2R zeroed
// ints (the row ticket, the pair ticket, the rows' progress, the rows'
// inter counts); ``lag_whole`` and ``lag_bpred`` the waits of a whole-mode
// and a B_PRED macroblock; ``blocks`` the blocks the card holds at once.
// Launches max(R, blocks) blocks, writes the number of kernel launches
// issued (1) to ``*n_launched`` and returns cudaGetLastError() after it.
extern "C" int rebase_frame_launch(const long long* p, int R, int C,
                                   void* sched, int lag_whole, int lag_bpred,
                                   int blocks, void* stream,
                                   int* n_launched) {
  RebaseArgs a;
  MbPlanes& m = a.p;
  m.oy = (const uint8_t*)p[0]; m.ou = (const uint8_t*)p[1];
  m.ov = (const uint8_t*)p[2];
  m.ry = (uint8_t*)p[3]; m.ru = (uint8_t*)p[4]; m.rv = (uint8_t*)p[5];
  m.tc = nullptr;
  m.vcost = nullptr;
  m.ynz = m.unz = m.vnz = m.y2c = nullptr;
  m.R = R; m.C = C;
  for (int i = 0; i < 6; ++i) m.q[i] = (int)p[17 + i];
  m.rm = m.dm = 0;
  for (int k = 0; k < 9; ++k) a.ref[k / 3][k % 3] = (const uint8_t*)p[6 + k];
  a.words = (const int*)p[15];
  a.out = (int16_t*)p[16];
  a.lag_whole = lag_whole;
  a.lag_bpred = lag_bpred;
  a.rs.ticket = (int*)sched;
  a.pair_ticket = (int*)sched + 1;
  a.rs.progress = (int*)sched + 2;
  a.inter_done = (int*)sched + 2 + R;
  a.rs.lag = lag_whole;
  *n_launched = 0;
  if (R * C == 0) return 0;
  rebase_row_kernel<<<R > blocks ? R : blocks, 256, 0,
                      (cudaStream_t)stream>>>(a);
  *n_launched = 1;
  return (int)cudaGetLastError();
}

// Blocks of the kernel the card ``device`` holds at once: blocks per SM at
// 256 threads times the SMs (0 on an error).
extern "C" int rebase_frame_resident(int device) {
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, rebase_row_kernel, 256, 0) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return 0;
  return per_sm * sms;
}
