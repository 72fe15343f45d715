// encode_kf_frame (K7): the keyframe encoder's macroblock loop on the card.
// Mode decision, transforms, quantization (plain or trellis) and the
// decoder-identical reconstruction of every macroblock of a key frame, in
// an order anti-diagonals d = 2*row + col allow (reference
// encoder/encode_intra.cc:36-456;
// plain version ops/enc_intra.py:encode_kf_frame_plain).
//
// Replaces the TPU kernel alfalfa_tpu/ops/enc_intra_pallas.py:
// encode_kf_frame (_enc_kernel), with the helpers traced inside it: H1
// (enc_transforms_pallas.py -> enc_transforms.cuh) and H2
// (trellis_pallas.py -> trellis.cuh).  Kept from it: the arithmetic, every
// tie-break (modes scanned ascending with strict '<', B_PRED only if
// strictly cheaper) and the wavefront order.  Not kept: the skewed
// diagonal storage, the rings of slabs, the permutation matmuls between
// tile and block layouts, the one-hot matmul for the contextual b-mode
// costs and the int32 cost argument: here the planes and per-macroblock
// state live in device memory, a block addresses its neighbours directly,
// tables are read by index and costs are int64.  For whole-macroblock luma
// the TPU kernel runs 16 trellis walks under all three entry contexts and
// picks afterwards; here the 16 backward passes run at once, and each
// block resolves its entry context from the others' choices (below).
//
// Design: one launch per call, persistent (row_sched.cuh).  A block of 256
// threads takes a row ticket and walks the row left to right, waiting
// before (r, c) for row r-1 to have published min(c + 2, C) macroblocks
// (ROW_LAG in ops/enc_intra_cuda.py: the B_PRED candidate reads the
// above-right neighbour) and publishing each macroblock once every output
// of it is written: the reconstruction, the mode words (the next row's
// b-mode context) and, for the trellis, the per-4x4 nonzero flags and the
// Y2 chains.  So no macroblock waits for a diagonal's slowest one, and
// there are no launch gaps (the parent design made 2*(R-1) + C dependent
// launches of at most 40 blocks).  While thread 0 waits, warp 2 copies the
// next macroblock's originals into shared memory (cp.async).  The cost
// tables (mode and b-mode costs, the trellis's token and value costs) are
// staged in shared memory once per block: the dependent B_PRED chain reads
// them, and after each acquire nothing cached in L1 can be trusted.  The
// macroblock steps are in enc_mb_device.cuh, shared with the interframe
// encoder (enc_inter.cu) and the intra fixup (enc_intra_fixup.cu).  The
// B_PRED candidate is warp 0's: its 16 sub-blocks, each depending on its
// left, above, above-left and above-right neighbours, run as 10 steps
// along the diagonals 2 sr + sc, a step's one or two sub-blocks on the
// warp's two 16-lane halves; lane p of a half predicts pixel p in all ten
// b-modes, shuffle sums give each mode's SSE, every lane scans the costs in
// mode order (the first strict minimum), and the transform chain runs on
// the half's 16 lanes (H1's lane forms), with __syncwarp between steps and
// no block barrier.  Meanwhile warps 1-7 (named barrier 1) run everything
// that does not read what B_PRED writes: the whole-mode costs, the
// whole-mode chain into a tile of its own, the chroma mode and chain; one
// block barrier then joins the two for the decision and the outputs
// (intra_mb, which K8's intra macroblocks run too).  The kernel has a
// one-pass and a two-pass instantiation, the launch choosing by the token
// costs.  The trellis (H2) splits its backward pass from the choice: the
// 16 whole-luma blocks and the 8 chroma blocks run their backward passes a
// thread each, and each resolves its chained context in raster order from
// the others' bits (as the TPU kernel and the plain version resolve them
// after the passes); inside the B_PRED chain each sub-block's walk stays
// serial, since later sub-blocks predict from its reconstruction.
//
// Bound: on paper device memory (the original planes in, coefficients,
// modes and reconstruction out: about 4.6 bytes per luma pixel); in
// practice the critical path: 2*(R-1) + C macroblocks one after another
// (168 at 720p), each its B_PRED chain of 10 dependent steps (a mode
// search and a transform chain on a half-warp, the trellis walk two-pass),
// beside which the whole-mode and chroma chains run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "enc_mb_device.cuh"  // the macroblock steps K7 shares with K8
#include "row_sched.cuh"      // the persistent row walk K7 shares with K8

#define MODE_WORDS 20  // ymode, uvmode, y2_coded, has_nonzero, 16 b-modes

struct EncArgs {
  MbPlanes p;                   // planes, trellis state, quantizers
  int16_t* coeffs;              // (R,C,25,16) raster order
  uint8_t* modes;               // (R,C,MODE_WORDS)
  const int* mbc;               // key-frame macroblock mode costs (5)
  const int* bcost;             // b-mode costs [above][left][mode] (1000)
  RowSched rs;
};

// Macroblock (r, c): its b-mode context, the load (originals from
// ``staged``), the intra encode and every output (two-pass: the trellis
// state too).  Called by all 256 threads; leaves the outputs unpublished.
template <bool kTrellis>
__device__ __forceinline__ void kf_mb(const EncArgs& a, const MbPlanes& P,
                                      MbShared& s, int r, int c,
                                      const uint8_t* staged) {
  const int tid = threadIdx.x;
  const int C = P.C, W = C * 16;
  const int mb = r * C + c;
  const bool trellis = kTrellis && P.tc != nullptr;

  // the b-mode context: the above MB's bottom row, the left one's right
  // column (B_DC_PRED, 0, off the frame); written during the launch, so
  // plain loads
  if (tid >= 128 && tid < 132) {
    const int k = tid - 128;
    s.nbm[k] = r > 0 ? a.modes[(size_t)(mb - C) * MODE_WORDS + 4 + 12 + k] : 0;
  } else if (tid >= 132 && tid < 136) {
    const int k = tid - 132;
    s.nbm[4 + k] = c > 0 ? a.modes[(size_t)(mb - 1) * MODE_WORDS + 4 + 4 * k + 3] : 0;
  }
  mb_load(P, s, r, c, staged);
  __syncthreads();  // the DC values
  const bool use_b = intra_mb(P, s, r, c, a.mbc, a.bcost, true, trellis,
                              false);
  const int wm = s.dec[0], um = s.dec[1];

  // ---- outputs: coefficients, modes, luma, the trellis state ----
  int any = 0;
  for (int i = tid; i < 400; i += 256) {
    const int blk = i >> 4, p = i & 15;
    int v;
    if (blk < 16) v = use_b ? s.bco[blk][p] : s.wco[blk][p];
    else if (blk < 24) v = s.uvco[blk - 16][p];
    else v = use_b ? 0 : s.y2[p];
    a.coeffs[(size_t)mb * 400 + i] = (int16_t)v;
    any |= v != 0;
  }
  const int py = tid >> 4, px = tid & 15;
  P.ry[(size_t)(r * 16 + py) * W + c * 16 + px] =
      (uint8_t)(use_b ? s.t[1 + py][1 + px] : s.wt[py][px]);
  const int has_nonzero = __syncthreads_or(any);
  uint8_t* md = a.modes + (size_t)mb * MODE_WORDS;
  if (tid < 16) {
    md[4 + tid] = (uint8_t)(use_b ? s.bm[tid] : imode_to_bmode(wm));
  } else if (tid == 16) {
    md[0] = (uint8_t)(use_b ? B_PRED : wm);
    md[1] = (uint8_t)um;
    md[2] = (uint8_t)!use_b;
    md[3] = (uint8_t)(has_nonzero != 0);
  }
  if (trellis) {
    const int C4 = 4 * C, C2 = 2 * C;
    if (tid >= 32 && tid < 48) {
      const int b = tid - 32, sr = b >> 2, sc = b & 3;
      P.ynz[(size_t)(4 * r + sr) * C4 + 4 * c + sc] = use_b ? s.bnz[b] : s.wnz[b];
    } else if (tid >= 64 && tid < 72) {
      const int k = tid - 64, pl = k >> 2, b = k & 3;
      (pl ? P.vnz : P.unz)[(size_t)(2 * r + (b >> 1)) * C2 + 2 * c + (b & 1)] = s.uvnz[k];
    } else if (tid == 96) {
      // a B_PRED macroblock has no Y2: it passes its neighbours' on
      uint8_t* y2 = P.y2c + (size_t)mb * 4;
      y2[0] = use_b ? s.ctx[16] : s.y2nz;
      y2[1] = use_b ? s.ctx[17] : 1;
      y2[2] = use_b ? s.ctx[18] : s.y2nz;
      y2[3] = use_b ? s.ctx[19] : 1;
    }
  }
}

// One block per row ticket, R blocks: the row's macroblocks left to right.
// Two instantiations: one-pass (kTrellis false: no trellis code, which
// would cost the one-pass chains registers) and the form that runs the
// trellis where it has token costs, launched for two-pass (testing them at
// run time, not knowing them at compile time, ran 8 % faster two-pass on
// an H100: the compiler's choice).
template <bool kTrellis>
__global__ void __launch_bounds__(256) enc_kf_row_kernel(EncArgs a) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  MB_SHARED(s);
  __shared__ __align__(16) uint8_t s_src[2][384];  // originals, by parity
  __shared__ int s_ticket;
  __shared__ int tab_mbc[5], tab_bcost[1000], tab_tc[4 * 576],
      tab_vcost[4096];

  // a copy, not a reference: its fields stay in registers along the
  // chains instead of being read from the parameters again; the tables
  // from shared memory
  MbPlanes P = a.p;
  for (int i = tid; i < 1000; i += 256) tab_bcost[i] = a.bcost[i];
  if (tid < 5) tab_mbc[tid] = a.mbc[tid];
  if (kTrellis && P.tc != nullptr) {
    for (int i = tid; i < 4 * 576; i += 256) tab_tc[i] = P.tc[i];
    for (int i = tid; i < 4096; i += 256) tab_vcost[i] = P.vcost[i];
    P.tc = tab_tc;
    P.vcost = tab_vcost;
  }
  EncArgs t = a;
  t.mbc = tab_mbc;
  t.bcost = tab_bcost;
  const int C = P.C;
  if (tid == 0) s_ticket = atomicAdd(a.rs.ticket, 1);
  __syncthreads();
  const int r = s_ticket;
  int* prog = a.rs.progress + r;
  const int lag = a.rs.lag;

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
    kf_mb<kTrellis>(t, P, s, r, c, s_src[c & 1]);
    __syncthreads();                // every output of (r, c) written
    if (tid == 0) row_publish(prog, c + 1);
  }
}

// Launch the persistent kernel for one frame on ``stream``: R blocks, one
// launch; ``sched`` is 1 + R zeroed ints (the ticket, then the rows'
// progress), ``lag`` the wait rule's lag (2).  Writes the number of kernel
// launches issued (1) to ``*n_launched`` and returns cudaGetLastError()
// after it.  ``tc`` null: plain quantization (then vcost and the flag
// buffers are not read).
extern "C" int encode_kf_frame_launch(
    const void* oy, const void* ou, const void* ov, void* ry, void* ru,
    void* rv, void* coeffs, void* modes, const void* mbc, const void* bcost,
    const void* tc, const void* vcost, void* ynz, void* unz, void* vnz,
    void* y2c, int ydc, int yac, int y2dc, int y2ac, int uvdc, int uvac,
    int rm, int dm, int R, int C, void* sched, int lag, void* stream,
    int* n_launched) {
  EncArgs a;
  MbPlanes& p = a.p;
  p.oy = (const uint8_t*)oy; p.ou = (const uint8_t*)ou; p.ov = (const uint8_t*)ov;
  p.ry = (uint8_t*)ry; p.ru = (uint8_t*)ru; p.rv = (uint8_t*)rv;
  p.tc = (const int*)tc;
  p.vcost = (const int*)vcost;
  p.ynz = (uint8_t*)ynz; p.unz = (uint8_t*)unz; p.vnz = (uint8_t*)vnz;
  p.y2c = (uint8_t*)y2c;
  p.R = R; p.C = C;
  const int q[6] = {ydc, yac, y2dc, y2ac, uvdc, uvac};
  for (int i = 0; i < 6; ++i) p.q[i] = q[i];
  p.rm = rm; p.dm = dm;
  a.coeffs = (int16_t*)coeffs;
  a.modes = (uint8_t*)modes;
  a.mbc = (const int*)mbc;
  a.bcost = (const int*)bcost;
  a.rs.ticket = (int*)sched;
  a.rs.progress = (int*)sched + 1;
  a.rs.lag = lag;
  if (tc != nullptr)
    enc_kf_row_kernel<true><<<R, 256, 0, (cudaStream_t)stream>>>(a);
  else
    enc_kf_row_kernel<false><<<R, 256, 0, (cudaStream_t)stream>>>(a);
  *n_launched = 1;
  return (int)cudaGetLastError();
}

// Blocks of the kernel (its two-pass form with ``trellis``) the card
// ``device`` holds at once: blocks per SM at 256 threads times the SMs (0
// on an error).
extern "C" int encode_kf_frame_resident(int device, int trellis) {
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, trellis ? enc_kf_row_kernel<true> : enc_kf_row_kernel<false>,
          256, 0) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return 0;
  return per_sm * sms;
}
