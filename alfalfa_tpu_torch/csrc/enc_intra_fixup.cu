// intra_fixup_frame (K10): the whole-mode intra encode of the macroblocks
// a fast rt interframe's decisions (K9) left intra, on the card, against
// their neighbours' final reconstruction, for one or several quantizers at
// once: DC / V / H / TM by variance rd-cost under the interframe's mode
// costs, the Y2 luma chain, the chroma mode of least SSE and its chain,
// plain quantization (the JAX package's encode_intra_np.encode_intra_mb with
// interframe=True, skip_bpred=True; plain version
// ops/enc_intra_fixup.py:intra_fixup_frame_plain).
//
// Replaces the TPU kernel alfalfa_tpu/ops/enc_intra_fixup_pallas.py:
// intra_fixup_frame (_fixup_kernel), with H1 (enc_transforms.cuh) inside.
// Kept from it: the arithmetic, the 127 / 129 edge rules (the TM corner
// 127 on the top row, 129 on the left column below it), the whole-mode scan
// from INF = 1 << 30 with strict '<', the chroma mode by SSE, and the
// outputs (coefficients and modes only for intra macroblocks).  Not kept:
// the raster walk over a reconstruction scratch, the tile and block
// layouts with their permutation matmuls, and the vmap over quantizers
// (here a block's ticket).
//
// Design: K7's macroblock steps (enc_mb_device.cuh: mb_load,
// whole_luma_costs, y2_path, chroma_mode, chroma_code) without B_PRED and
// the trellis, in one launch per call, persistent (row_sched.cuh).  A block
// of 256 threads takes a (row, quantizer) ticket.  An inter macroblock is
// final at launch: the block first copies its row's inter macroblocks into
// the output planes and zeroes their coefficients and modes (which folds
// the wrapper's copies of the planes into the walk), then visits the row's
// intra macroblocks only, left to right.  An intra macroblock reads its
// left, above and above-left neighbours (d = r + c), so before (r, c) the
// block waits for row r-1 of its quantizer to have published min(c + 1, C)
// (ROW_LAG in ops/enc_intra_fixup_cuda.py).  It publishes once per run of
// inter macroblocks, not once per macroblock: at the start the column of
// its first intra macroblock, after each intra macroblock the column of
// the next (C at the end), since everything before it is final.  A row
// with no intra macroblock publishes C at once, and the critical path runs
// through chained intra macroblocks only.  Any published value is at least
// 1 only after the copies, so a satisfied wait also finds the row above's
// inter macroblocks in the output.  Every thread finds the next intra
// column itself (a warp ballot over the decision words), so the walk needs
// no barrier for it.  While thread 0 waits, warp 2 copies the next intra
// macroblock's originals into shared memory (cp.async).  mb_load also reads
// the above-right pixels, which B_PRED alone uses: at lag 1 they may be in
// flight, and they land only in the working tile's above-right cells,
// which whole modes never read.  Launches per call: 1, whatever the number
// of quantizers (the parent design made R + C - 1 diagonal launches, most
// of whose blocks returned at once).
//
// Bound: bytes for a frame with few intra macroblocks (the inter planes
// copied, the decisions read, coefficients written); per intra macroblock,
// K7's whole-mode and chroma searches and 25 transform chains.  In
// practice the critical path: the longest chain of intra macroblocks
// linked left, above or above-left (at most R + C - 1), each about a dozen
// block barriers, or, without one, the slowest row's own intra
// macroblocks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "enc_mb_device.cuh"  // the macroblock steps K10 shares with K7, K8
#include "row_sched.cuh"      // the persistent row walk K10 shares with K5-K9

#define DECIDE_WORDS 8  // K9's words per macroblock; word 0: is_inter
#define FIXUP_WORDS 3   // whole mode, chroma mode, any nonzero coefficient
#define N_SCALARS 9     // y_dc, y_ac, y2_dc, y2_ac, uv_dc, uv_ac, rate and
                        // distortion multipliers, SAD per bit
#define FIXUP_INF (1LL << 30)

struct FixupArgs {
  MbPlanes p;          // originals; quantizer 0's output planes (the kernel
                       // offsets them by its quantizer)
  const uint8_t *iy, *iu, *iv;  // (Q,16R,16C), (Q,8R,8C): the inter
                                // macroblocks' reconstruction
  const int* md;       // (Q,R,C,DECIDE_WORDS) K9's decisions
  int16_t* coeffs;     // (Q,R,C,25,16) raster order, zero at inter MBs
  int* modes;          // (Q,R,C,FIXUP_WORDS), zero at inter MBs
  const int* scalars;  // (Q,N_SCALARS)
  const int* mbc;      // interframe macroblock mode costs (5)
  int Q;
  RowSched rs;         // progress (Q, R)
};

// The first column at or after ``c`` whose macroblock is intra in the
// decision row ``md`` (C if none): the calling warp scans 32 columns at a
// time, so every warp finds it without a barrier.
__device__ __forceinline__ int next_intra(const int* md, int c, int C) {
  const int lane = threadIdx.x & 31;
  for (int base = c; base < C; base += 32) {
    const int k = base + lane;
    const unsigned m = __ballot_sync(
        0xffffffffu, k < C && md[(size_t)k * DECIDE_WORDS] == 0);
    if (m) return base + __ffs(m) - 1;
  }
  return C;
}

// Intra macroblock (r, c) at the block's quantizer, its originals in
// ``staged``: the encode and every output.  Called by all 256 threads;
// leaves the outputs unpublished.
__device__ __forceinline__ void fixup_mb(const FixupArgs& a, const MbPlanes& P,
                                         MbShared& s, int16_t* co, int* m,
                                         int r, int c, const uint8_t* staged) {
  const int tid = threadIdx.x, W = P.C * 16;
  mb_load(P, s, r, c, staged);
  __syncthreads();                                   // the DC values
  whole_luma_costs(P, s, a.mbc, FIXUP_INF);          // s.dec[0]
  y2_path(P, s, false, WholePred{s.dec[0]});
  chroma_mode(s);
  chroma_code(P, s, r, c, false, WholePred{s.dec[1]});

  int any = 0;
  for (int i = tid; i < 400; i += 256) {
    const int blk = i >> 4, p = i & 15;
    const int v = blk < 16 ? s.wco[blk][p] : blk < 24 ? s.uvco[blk - 16][p]
                                                      : s.y2[p];
    co[i] = (int16_t)v;
    any |= v != 0;
  }
  const int py = tid >> 4, px = tid & 15;
  P.ry[(size_t)(r * 16 + py) * W + c * 16 + px] = (uint8_t)s.t[1 + py][1 + px];
  const int nz = __syncthreads_or(any);
  if (tid == 0) {
    m[0] = s.dec[0];
    m[1] = s.dec[1];
    m[2] = nz != 0;
  }
}

// One block per (row, quantizer) ticket, the quantizer inner; R * Q blocks.
__global__ void __launch_bounds__(256) enc_fixup_row_kernel(FixupArgs a) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  MB_SHARED(s);
  __shared__ __align__(16) uint8_t s_src[2][384];  // originals, by parity
  __shared__ int s_ticket;
  if (tid == 0) s_ticket = atomicAdd(a.rs.ticket, 1);
  __syncthreads();
  const int Q = a.Q, R = a.p.R, C = a.p.C, W = C * 16, Wc = C * 8;
  const int r = s_ticket / Q, qp = s_ticket % Q;
  const size_t n_mb = (size_t)R * C, mb0 = qp * n_mb + (size_t)r * C;
  // a copy, not a reference: its fields stay in registers
  MbPlanes P = a.p;
  P.ry += qp * n_mb * 256;
  P.ru += qp * n_mb * 64;
  P.rv += qp * n_mb * 64;
  const int* sc = a.scalars + qp * N_SCALARS;
  for (int i = 0; i < 6; ++i) P.q[i] = sc[i];
  P.rm = sc[6];
  P.dm = sc[7];
  const int* md = a.md + mb0 * DECIDE_WORDS;
  int* prog = a.rs.progress + qp * R + r;
  const int lag = a.rs.lag;

  // the row's inter macroblocks are final: pixels copied, coefficients and
  // modes zero (adjacent threads on adjacent 16- and 8-byte words)
  const uint8_t* iy = a.iy + qp * n_mb * 256;
  for (int i = tid; i < 16 * C; i += 256) {
    const int c = i % C, o = (r * 16 + i / C) * W + c * 16;
    if (md[(size_t)c * DECIDE_WORDS] != 0)
      *reinterpret_cast<uint4*>(P.ry + o) =
          __ldg(reinterpret_cast<const uint4*>(iy + o));
  }
  for (int i = tid; i < 16 * C; i += 256) {
    const int pl = i / (8 * C), k = i % (8 * C), c = k % C;
    const int o = (r * 8 + k / C) * Wc + c * 8;
    const uint8_t* in = (pl ? a.iv : a.iu) + qp * n_mb * 64;
    if (md[(size_t)c * DECIDE_WORDS] != 0)
      *reinterpret_cast<uint2*>((pl ? P.rv : P.ru) + o) =
          __ldg(reinterpret_cast<const uint2*>(in + o));
  }
  for (int i = tid; i < 50 * C; i += 256) {
    const int c = i / 50;
    if (md[(size_t)c * DECIDE_WORDS] != 0)
      reinterpret_cast<uint4*>(a.coeffs + (mb0 + c) * 400)[i % 50] =
          make_uint4(0, 0, 0, 0);
  }
  for (int i = tid; i < FIXUP_WORDS * C; i += 256) {
    const int c = i / FIXUP_WORDS;
    if (md[(size_t)c * DECIDE_WORDS] != 0)
      a.modes[(mb0 + c) * FIXUP_WORDS + i % FIXUP_WORDS] = 0;
  }

  int c = next_intra(md, 0, C);
  __syncthreads();                  // the copies written
  if (tid == 0) row_publish(prog, c);
  if (warp == 2 && c < C)
    stage_originals(s_src[0], P.oy, P.ou, P.ov, r, c, C, lane, true);
  cp_async_commit();
  for (int k = 0; c < C; ++k) {
    const int nxt = next_intra(md, c + 1, C);
    // the next intra macroblock's originals, while thread 0 waits
    if (warp == 2 && nxt < C)
      stage_originals(s_src[(k + 1) & 1], P.oy, P.ou, P.ov, r, nxt, C, lane,
                      true);
    cp_async_commit();
    if (tid == 0 && r > 0) row_wait(prog - 1, min(c + lag, C));
    cp_async_wait<1>();
    __syncthreads();
    fixup_mb(a, P, s, a.coeffs + (mb0 + c) * 400,
             a.modes + (mb0 + c) * FIXUP_WORDS, r, c, s_src[k & 1]);
    __syncthreads();                // every output of (r, c) written
    if (tid == 0) row_publish(prog, nxt);
    c = nxt;
  }
}

// Launch the persistent kernel for one frame at Q quantizers on
// ``stream``: R * Q blocks, one launch.  y / u / v hold the inter
// macroblocks' reconstruction (read only); Y / U / V, coeffs and modes are
// written whole; ``sched`` is 1 + Q * R zeroed ints (the ticket, then the
// rows' progress), ``lag`` the wait rule's lag (1).  Writes the number of
// kernel launches issued (1) to ``*n_launched`` and returns
// cudaGetLastError() after it.
extern "C" int intra_fixup_frame_launch(
    const void* oy, const void* ou, const void* ov, const void* md,
    const void* y, const void* u, const void* v, void* Y, void* U, void* V,
    void* coeffs, void* modes, const void* scalars, const void* mbc, int Q,
    int R, int C, void* sched, int lag, void* stream, int* n_launched) {
  FixupArgs a;
  MbPlanes& p = a.p;
  p.oy = (const uint8_t*)oy; p.ou = (const uint8_t*)ou; p.ov = (const uint8_t*)ov;
  p.ry = (uint8_t*)Y; p.ru = (uint8_t*)U; p.rv = (uint8_t*)V;
  p.tc = nullptr;
  p.vcost = nullptr;
  p.ynz = p.unz = p.vnz = p.y2c = nullptr;
  p.R = R; p.C = C;
  for (int i = 0; i < 6; ++i) p.q[i] = 0;  // per quantizer, from scalars
  p.rm = p.dm = 0;
  a.iy = (const uint8_t*)y; a.iu = (const uint8_t*)u; a.iv = (const uint8_t*)v;
  a.md = (const int*)md;
  a.coeffs = (int16_t*)coeffs;
  a.modes = (int*)modes;
  a.scalars = (const int*)scalars;
  a.mbc = (const int*)mbc;
  a.Q = Q;
  a.rs.ticket = (int*)sched;
  a.rs.progress = (int*)sched + 1;
  a.rs.lag = lag;
  enc_fixup_row_kernel<<<R * Q, 256, 0, (cudaStream_t)stream>>>(a);
  *n_launched = 1;
  return (int)cudaGetLastError();
}

// Blocks of the kernel the card ``device`` holds at once: blocks per SM at
// 256 threads times the SMs (0 on an error).
extern "C" int intra_fixup_frame_resident(int device) {
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, enc_fixup_row_kernel, 256, 0) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return 0;
  return per_sm * sms;
}
