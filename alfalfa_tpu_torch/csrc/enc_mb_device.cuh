// Macroblock encode steps shared by the key-frame encoder (enc_intra.cu:
// K7), the interframe encoder (enc_inter.cu: K8) and the fast path's intra
// fixup (enc_intra_fixup.cu: K10, whole modes only): the loads of a
// macroblock's originals and reconstructed edges, the whole-mode luma
// costs, the B_PRED candidate with reconstruction in the loop (contextual
// key-frame b-mode costs or the interframe's non-contextual ones), the
// luma Y2 path and the chroma mode search and transform chain, each with
// plain or trellis quantization.  One block of 256 threads runs one
// macroblock; every step is called by all its threads, and each says what
// its last phase leaves unpublished (a barrier costs about as much as a
// small step, so there is no barrier a caller does not need).  The intra
// macroblock (intra_mb, K7's and K8's) runs the B_PRED candidate on warp 0
// (a chain of 16 dependent sub-blocks, each spread over the warp's lanes,
// with __syncwarp between them) while warps 1-7 run the whole-mode and
// chroma steps, which read nothing it writes.
// Every step is inlined, and the kernels pass a local copy of MbPlanes and
// an MbShared of distinct shared arrays, so the planes, quantizers,
// multipliers and the working values stay in registers along the serial
// one-thread chains (with a reference to the parameters and one shared
// struct, the compiler read both again after stores, and K7 ran slower on
// an H100 than with its own shared arrays).
// The reference is encoder/encode_intra.cc:36-456 (the JAX
// package's host loop encoder/encode_intra_np.py:encode_intra_mb); the
// thread layout is described in enc_intra.cu's source note.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "enc_transforms.cuh"
#include "intra_device.cuh"
#include "trellis.cuh"

#define B_PRED 4
// block types (tables.py): the token-cost table rows
#define BT_Y_AFTER_Y2 0
#define BT_Y2 1
#define BT_UV 2
#define BT_Y_WITHOUT_Y2 3

// What a macroblock's encode reads and writes in device memory.
struct MbPlanes {
  const uint8_t *oy, *ou, *ov;  // original planes (16R,16C), (8R,8C)
  uint8_t *ry, *ru, *rv;        // this frame's reconstruction, unfiltered
  const int* tc;                // (4,16,36) token costs, null: no trellis
  const int* vcost;             // (4096) value costs (trellis)
  uint8_t *ynz, *unz, *vnz;     // nonzero flags (4R,4C), (2R,2C) (trellis)
  uint8_t* y2c;                 // (R,C,4) Y2 chains: column nz, valid,
                                // row nz, valid after the MB (trellis)
  int R, C;
  int q[6];                     // y_dc, y_ac, y2_dc, y2_ac, uv_dc, uv_ac
  int rm, dm;                   // rate and distortion multipliers
};

// A macroblock's working state in shared memory.  Each array is a
// __shared__ variable of its own, declared in the kernel by MB_SHARED, and
// the struct holds references to them: distinct variables cannot alias, so
// the compiler keeps values in registers across the one-thread chains'
// stores (fields of one shared struct indexed at run time would have to
// be read again after each store).
struct MbShared {
  int (&o)[256];          // original luma, raster
  int (&oc)[2][64];       // original U, V
  int (&t)[17][21];       // luma working tile: row 0 = above-left, above
                          // x16, above-right x4; column 0 = left; cell
                          // (1+y, 1+x) = pixel (y, x)
  int (&ce)[2][9];        // chroma above-left + above (U, V)
  int (&cl)[2][8];        // chroma left column
  int (&dc)[3];           // whole-block DC values: Y, U, V
  int (&p16)[256];        // the luma prediction the Y2 path codes
  int (&wt)[16][16];      // the whole-mode reconstruction, where the Y2
                          // path runs beside the B_PRED candidate
  int (&pc)[2][64];       // the chroma predictions the chroma chain codes
  int (&edge)[2][13];     // the edges (bpred_pixel's E) of the sub-blocks
                          // warp 0's halves predict
  int (&bm)[16];          // B_PRED candidate b-modes
  int (&nbm)[8];          // above MB's bottom row, left MB's right column
                          // of b-modes (key frames: the b-mode context)
  int (&bco)[16][16];     // B_PRED candidate coefficients
  int (&wco)[16][16];     // Y2-path luma coefficients
  int (&walsh)[16];       // Y2-path luma DCs
  int (&y2)[16];          // Y2 coefficients
  int (&dcv)[16];         // the luma DCs the decoder rebuilds
  int (&uvco)[8][16];     // U blocks 0-3, V blocks 4-7
  uint8_t (&ctx)[20];     // neighbours' trellis flags: Y above 0-3, Y left
                          // 4-7, U above 8-9, U left 10-11, V above 12-13,
                          // V left 14-15, Y2 column nz/valid 16-17, Y2 row
                          // nz/valid 18-19
  uint8_t (&bnz)[16];
  uint8_t (&wnz)[16];
  uint8_t (&uvnz)[8];
  uint8_t (&tsel)[16];    // trellis blocks whose contexts chain: the start
                          // level per context (bits 0-2) and the nonzero
                          // flag per start level (bits 3-4)
  uint8_t& y2nz;
  long long (&red)[8][8];
  long long& wcost;       // the best whole-mode cost
  long long& bcost;       // the B_PRED candidate's cost
  int (&dec)[2];          // whole mode, chroma mode
};

// Declares the shared arrays of one macroblock's state and ``s``, the
// MbShared over them (arrays a kernel never reads take no memory).
#define MB_SHARED(s)                                                      \
  __shared__ int s##_o[256], s##_oc[2][64], s##_t[17][21], s##_ce[2][9],  \
      s##_cl[2][8], s##_dc[3], s##_p16[256], s##_wt[16][16],              \
      s##_pc[2][64], s##_edge[2][13], s##_bm[16], s##_nbm[8],             \
      s##_bco[16][16], s##_wco[16][16], s##_walsh[16], s##_y2[16],        \
      s##_dcv[16], s##_uvco[8][16], s##_dec[2];                           \
  __shared__ uint8_t s##_ctx[20], s##_bnz[16], s##_wnz[16], s##_uvnz[8],  \
      s##_tsel[16], s##_y2nz;                                             \
  __shared__ long long s##_red[8][8], s##_wcost, s##_bcost;               \
  MbShared s{s##_o,     s##_oc,    s##_t,    s##_ce,   s##_cl,   s##_dc,  \
             s##_p16,   s##_wt,    s##_pc,   s##_edge, s##_bm,   s##_nbm, \
             s##_bco,   s##_wco,   s##_walsh, s##_y2,  s##_dcv,  s##_uvco,\
             s##_ctx,   s##_bnz,   s##_wnz,  s##_uvnz, s##_tsel, s##_y2nz,\
             s##_red,   s##_wcost, s##_bcost, s##_dec}

// The threads running a step: the whole block (BlockTeam: barrier 0, the
// Y2 path's reconstruction into the working tile), or warps 1-7 while warp
// 0 runs the B_PRED candidate (SideTeam: named barrier 1 of 224 threads,
// which warp 0 never waits at; the reconstruction into s.wt, since B_PRED
// writes the working tile meanwhile).  Thread t of a team is its tid().
struct BlockTeam {
  static constexpr int kThreads = 256, kWarps = 8;
  static __device__ __forceinline__ int tid() { return threadIdx.x; }
  static __device__ __forceinline__ void sync() { __syncthreads(); }
  static __device__ __forceinline__ int& rec(MbShared& s, int y, int x) {
    return s.t[1 + y][1 + x];
  }
};
struct SideTeam {
  static constexpr int kThreads = 224, kWarps = 7;
  static __device__ __forceinline__ int tid() { return threadIdx.x - 32; }
  static __device__ __forceinline__ void sync() {
    asm volatile("bar.sync 1, 224;" ::: "memory");
  }
  static __device__ __forceinline__ int& rec(MbShared& s, int y, int x) {
    return s.wt[y][x];
  }
};

__device__ __forceinline__ int imode_to_bmode(int m) {
  // whole mode (DC, V, H, TM) -> the b-mode neighbours see
  return m == 0 ? 0 : m == 1 ? 2 : m == 2 ? 3 : 1;
}

// The originals of macroblock (r, c) (from ``staged``, 384 shared bytes:
// 16x16 luma, 8x8 U, 8x8 V, where the caller copied them ahead; else from
// the planes), its edges in the reconstruction, the neighbours' trellis
// flags (with a.tc), then the three DC values.  The neighbour state may
// have been written during the launch (the persistent K8, after its
// acquire and barrier): plain loads, never the non-coherent path.  Leaves
// threads 128-159 and 180-255 free for the caller's own loads before the
// call, whose barrier publishes them.  The DC values (threads 0, 32, 64)
// are published by the caller's next barrier: the B_PRED candidate does
// not read them.
__device__ __forceinline__ void mb_load(const MbPlanes& a, MbShared& s,
                                        int r, int c,
                                        const uint8_t* staged = nullptr) {
  const int tid = threadIdx.x;
  const int C = a.C, W = C * 16, Wc = C * 8;
  const bool hrow = r > 0, hcol = c > 0, lastc = c == C - 1;
  const int y0 = r * 16, x0 = c * 16, cy0 = r * 8, cx0 = c * 8;
  const int mb = r * C + c;
  if (staged != nullptr) {
    s.o[tid] = staged[tid];
    if (tid < 128) s.oc[tid >> 6][tid & 63] = staged[256 + tid];
  } else {
    s.o[tid] = a.oy[(size_t)(y0 + (tid >> 4)) * W + x0 + (tid & 15)];
    if (tid < 128) {
      const int pl = tid >> 6, k = tid & 63;
      s.oc[pl][k] = (pl ? a.ov : a.ou)[(size_t)(cy0 + (k >> 3)) * Wc + cx0 + (k & 7)];
    }
  }
  const uint8_t* Yp = a.ry;
  if (tid < 16) {
    s.t[0][1 + tid] = hrow ? Yp[(size_t)(y0 - 1) * W + x0 + tid] : 127;
  } else if (tid < 20) {
    const int k = tid - 16;
    // the last column repeats the above row's last pixel
    s.t[0][17 + k] = !hrow ? 127
                     : lastc ? Yp[(size_t)(y0 - 1) * W + x0 + 15]
                             : Yp[(size_t)(y0 - 1) * W + x0 + 16 + k];
  } else if (tid == 20) {
    s.t[0][0] = !hrow ? 127 : hcol ? Yp[(size_t)(y0 - 1) * W + x0 - 1] : 129;
  } else if (tid >= 32 && tid < 48) {
    const int k = tid - 32;
    s.t[1 + k][0] = hcol ? Yp[(size_t)(y0 + k) * W + x0 - 1] : 129;
  } else if (tid >= 64 && tid < 128) {
    const int pl = (tid - 64) >> 5, k = (tid - 64) & 31;
    const uint8_t* P = pl ? a.rv : a.ru;
    if (k < 8) {
      s.ce[pl][1 + k] = hrow ? P[(size_t)(cy0 - 1) * Wc + cx0 + k] : 127;
    } else if (k == 8) {
      s.ce[pl][0] = !hrow ? 127 : hcol ? P[(size_t)(cy0 - 1) * Wc + cx0 - 1] : 129;
    } else if (k >= 16 && k < 24) {
      s.cl[pl][k - 16] = hcol ? P[(size_t)(cy0 + k - 16) * Wc + cx0 - 1] : 129;
    }
  } else if (tid >= 160 && tid < 180) {
    const int k = tid - 160;
    uint8_t v = 0;
    if (a.tc != nullptr) {
      const int C4 = 4 * C, C2 = 2 * C;
      if (k < 4) {
        v = hrow ? a.ynz[(size_t)(4 * r - 1) * C4 + 4 * c + k] : 0;
      } else if (k < 8) {
        v = hcol ? a.ynz[(size_t)(4 * r + k - 4) * C4 + 4 * c - 1] : 0;
      } else if (k < 16) {
        const uint8_t* nzp = k < 12 ? a.unz : a.vnz;
        const int j = k & 3;
        if (j < 2) v = hrow ? nzp[(size_t)(2 * r - 1) * C2 + 2 * c + j] : 0;
        else v = hcol ? nzp[(size_t)(2 * r + j - 2) * C2 + 2 * c - 1] : 0;
      } else if (k < 18) {
        v = hrow ? a.y2c[(size_t)(mb - C) * 4 + k - 16] : 0;
      } else {
        v = hcol ? a.y2c[(size_t)(mb - 1) * 4 + k - 16] : 0;
      }
    }
    s.ctx[k] = v;
  }
  __syncthreads();
  if (tid == 0) {
    int sa = 0, sl = 0;
    for (int k = 0; k < 16; ++k) { sa += s.t[0][1 + k]; sl += s.t[1 + k][0]; }
    s.dc[0] = dc_value(sa, sl, hrow, hcol, 4);
  } else if (tid == 32 || tid == 64) {
    const int pl = tid == 64;
    int sa = 0, sl = 0;
    for (int k = 0; k < 8; ++k) { sa += s.ce[pl][1 + k]; sl += s.cl[pl][k]; }
    s.dc[1 + pl] = dc_value(sa, sl, hrow, hcol, 3);
  }
}

// Whole-MB luma, DC, V, H, TM by variance (sse - s*s/256) rd-cost under
// mbc[0..3]: the first of least cost in s.dec[0], its cost in s.wcost.
// With ``start`` >= 0 the scan starts from that cost instead of DC's (the
// fast path's INF: a mode costing it or more is never taken, and DC is
// kept if all do).
template <typename Team = BlockTeam>
__device__ __forceinline__ void whole_luma_costs(const MbPlanes& a,
                                                 MbShared& s, const int* mbc,
                                                 long long start = -1) {
  const int tid = Team::tid(), lane = tid & 31, warp = tid >> 5;
  {
    long long acc[8];
    if constexpr (Team::kThreads == 256) {  // a pixel a thread
      const int py = tid >> 4, px = tid & 15;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int pred = whole_pixel(m, s.dc[0], s.t[0][1 + px],
                                     s.t[1 + py][0], s.t[0][0]);
        const int diff = s.o[tid] - pred;
        acc[m] = diff;
        acc[4 + m] = diff * diff;
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] = 0;
      for (int i = tid; i < 256; i += Team::kThreads) {
        const int py = i >> 4, px = i & 15;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int pred = whole_pixel(m, s.dc[0], s.t[0][1 + px],
                                       s.t[1 + py][0], s.t[0][0]);
          const int diff = s.o[i] - pred;
          acc[m] += diff;
          acc[4 + m] += diff * diff;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      for (int o = 16; o; o >>= 1) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], o);
      if (lane == 0) s.red[warp][k] = acc[k];
    }
  }
  Team::sync();
  if (tid == 0) {
    int wm = 0;
    long long wcost = start;
    for (int m = 0; m < 4; ++m) {
      long long sm = 0, sse = 0;
      for (int w = 0; w < Team::kWarps; ++w) { sm += s.red[w][m]; sse += s.red[w][4 + m]; }
      const long long cost = rdcost(mbc[m], sse - sm * sm / 256, a.rm, a.dm);
      if ((m == 0 && start < 0) || cost < wcost) { wcost = cost; wm = m; }
    }
    s.dec[0] = wm;
    s.wcost = wcost;
  }
  Team::sync();
}

// The B_PRED candidate, warp 0's (the other warps return at once):
// the 16 sub-blocks, each scoring the ten b-modes by SSE rd-cost, then its
// transform chain into the working tile the later ones predict from.  A
// sub-block reads its left, above, above-left and above-right neighbours
// only (the right column's above-right lies above the macroblock), so the
// ones on a diagonal d = 2 sr + sc depend only on earlier diagonals: the
// chain is 10 steps, not 16, each step's one or two sub-blocks on the
// warp's two 16-lane halves (where a step has one, the second half repeats
// the first's without writing).  The sums, rates and contexts are those of
// raster order, which the plain version walks: integer sums in another
// order, each context from a sub-block already done.  Lane p of a half
// predicts pixel p in all ten modes, each mode known at compile time (no
// divergent switch), 16-lane shuffle sums give each mode's SSE, and every
// lane scans the ten costs in mode order with strict '<' (the first strict
// minimum).  The chain runs on the half's 16 lanes (H1's lane forms); with
// ``trellis`` every lane of a half runs its sub-block's backward pass on
// the same shared coefficients and quantizes its own position.  b-mode
// rates: with ``contextual``, bcost[(above * 10 + left) * 10 + mode] under
// the neighbours' modes (s.nbm off the macroblock); else bcost[mode].  Its
// rd-cost in s.bcost, modes, coefficients and flags in s.bm, s.bco, s.bnz:
// warp 0's, published by the caller's next barrier.
__device__ __forceinline__ void bpred_candidate(const MbPlanes& a,
                                                MbShared& s, const int* mbc,
                                                const int* bcost,
                                                bool contextual, bool trellis) {
  const int lane = threadIdx.x;
  if (lane >= 32) return;
  const int p = lane & 15, h = lane >> 4, ly = p >> 2, lx = p & 3;
  const int f = p ? a.q[1] : a.q[0];    // this lane's quantizer factor
  const unsigned inv = quantize_inv(f);
  long long b_rate = 0, b_dist = 0;     // this half's sub-blocks
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
    const int* rates = bcost;
    if (contextual) {
      const int above = sr ? s.bm[sb - 4] : s.nbm[sc];
      const int left = sc ? s.bm[sb - 1] : s.nbm[4 + sr];
      rates = bcost + (above * 10 + left) * 10;
    }
    const int o = s.o[(y0 + ly) * 16 + x0 + lx];
    __syncwarp();
    int pm[10], v[10];
#pragma unroll
    for (int m = 0; m < 10; ++m) {
      pm[m] = bpred_pixel(m, E, ly, lx);
      v[m] = (o - pm[m]) * (o - pm[m]);
    }
#pragma unroll
    for (int sh = 8; sh; sh >>= 1)
#pragma unroll
      for (int m = 0; m < 10; ++m) v[m] += __shfl_xor_sync(0xffffffffu, v[m], sh);
    // selects with compile-time indices: pm[best] would put the arrays in
    // local memory
    long long best_cost = rdcost(rates[0], v[0], a.rm, a.dm);
    int best = 0, pred = pm[0], sse = v[0];
#pragma unroll
    for (int m = 1; m < 10; ++m) {
      const long long cost = rdcost(rates[m], v[m], a.rm, a.dm);
      if (cost < best_cost) {
        best_cost = cost; best = m; pred = pm[m]; sse = v[m];
      }
    }
    if (active) {
      b_rate += rates[best];
      b_dist += sse;
    }
    const int co = fdct4x4_lane(o - pred, p);
    int q;
    if (trellis) {
      if (active) s.bco[sb][p] = co;     // unquantized
      __syncwarp();
      const int up = sr ? s.bnz[sb - 4] : s.ctx[sc];
      const int lf = sc ? s.bnz[sb - 1] : s.ctx[4 + sr];
      const int* tc = a.tc + BT_Y_WITHOUT_Y2 * 576;
      const TrellisNodes n = trellis_backward(s.bco[sb], a.q[0], a.q[1], tc,
                                              a.vcost, 0, a.rm, a.dm);
      unsigned levels;
      const int end = trellis_path(
          n, 0, trellis_choose(n, tc, 0, up + lf, a.rm, a.dm), levels);
      q = trellis_coeff(co, f, unzigzag(p), 0, end, levels);
      __syncwarp();
      if (active && p == 0) s.bnz[sb] = trellis_nonzero(n, 0, end, levels);
    } else {
      q = quantize_lane(co, inv);
    }
    const int res = idct4x4_lane(dequantize_lane(q, f), p);
    if (active) {
      s.bco[sb][p] = q;
      s.t[y0 + 1 + ly][x0 + 1 + lx] = clampi(pred + res, 0, 255);
      if (p == 0) s.bm[sb] = best;
    }
    __syncwarp();
  }
  b_rate += __shfl_xor_sync(0xffffffffu, b_rate, 16);
  b_dist += __shfl_xor_sync(0xffffffffu, b_dist, 16);
  if (lane == 0) s.bcost = rdcost(mbc[B_PRED] + b_rate, b_dist, a.rm, a.dm);
}

// Where the luma and chroma chains take their prediction from: the whole
// mode chosen (computed from the edges, which the chains do not write), or
// the tile in s.p16 / s.pc (six-tap, filled and published by the caller).
struct WholePred {
  int mode;
  __device__ int luma(const MbShared& s, int py, int px) const {
    return whole_pixel(mode, s.dc[0], s.t[0][1 + px], s.t[1 + py][0], s.t[0][0]);
  }
  __device__ int chroma(const MbShared& s, int pl, int cy, int cx) const {
    return whole_pixel(mode, s.dc[1 + pl], s.ce[pl][1 + cx], s.cl[pl][cy],
                       s.ce[pl][0]);
  }
};
struct TilePred {
  __device__ int luma(const MbShared& s, int py, int px) const {
    return s.p16[py * 16 + px];
  }
  __device__ int chroma(const MbShared& s, int pl, int cy, int cx) const {
    return s.pc[pl][cy * 8 + cx];
  }
};

// The trellis of ``n`` blocks whose entry contexts chain, after each
// block's backward pass ran on a thread of its own: that thread's bits for
// s.tsel (the start level under each context 0-2, the nonzero flag of each
// start level's walk), with the two walks' (end, levels) kept in ``end``
// and ``levels`` for the coefficients once the contexts are resolved.
__device__ __forceinline__ int trellis_bits(const TrellisNodes& n,
                                            const int* tc, int first, int rm,
                                            int dm, int (&end)[2],
                                            unsigned (&levels)[2]) {
  int bits = 0;
#pragma unroll
  for (int ctx = 0; ctx < 3; ++ctx)
    bits |= trellis_choose(n, tc, first, ctx, rm, dm) << ctx;
#pragma unroll
  for (int ch = 0; ch < 2; ++ch) {
    end[ch] = trellis_path(n, first, ch, levels[ch]);
    bits |= trellis_nonzero(n, first, end[ch], levels[ch]) << (3 + ch);
  }
  return bits;
}

// The start level of block ``b`` of a w x w grid of chained blocks
// (their bits in tsel, raster order): the grid resolved in raster order up
// to b from the flags above it (abv[k], column k) and left of it (lft[k],
// row k); b's nonzero flag into ``nz``.  Each block's thread resolves the
// chain itself (bit operations on shared bytes), so no thread walks it for
// the others.
__device__ __forceinline__ int trellis_resolve(const uint8_t* tsel,
                                               const uint8_t* abv,
                                               const uint8_t* lft, int w,
                                               int b, uint8_t& nz) {
  unsigned flags = 0;  // bit k: block k's nonzero flag
  int ch = 0;
  for (int k = 0; k <= b; ++k) {
    const int sr = k / w, sc = k % w;
    const int ctx = (sr ? (flags >> (k - w)) & 1 : abv[sc]) +
                    (sc ? (flags >> (k - 1)) & 1 : lft[sr]);
    const int bits = tsel[k];
    ch = (bits >> ctx) & 1;
    flags |= (unsigned)((bits >> (3 + ch)) & 1) << k;
  }
  nz = (flags >> b) & 1;
  return ch;
}

// The whole-macroblock luma chain of ``pred``'s luma: 16 fDCTs, their DCs
// through the WHT into Y2, quantization (the trellis with ``trellis``: the
// 16 backward passes at once, a thread each, then each block's walk under
// its resolved context, while thread 32 quantizes Y2 under its chains),
// and the decoder's reconstruction into Team::rec (the working tile's
// pixels, or s.wt) by the team's threads 0-15, unpublished.
template <typename Pred, typename Team = BlockTeam>
__device__ __forceinline__ void y2_path(const MbPlanes& a, MbShared& s,
                                        bool trellis, Pred pred) {
  const int tid = Team::tid();
  const int ydc = a.q[0], yac = a.q[1], y2dc = a.q[2], y2ac = a.q[3];
  const int* tcy = a.tc + BT_Y_AFTER_Y2 * 576;
  int end[2];
  unsigned levels[2];
  if (tid < 16) {
    const int sr = tid >> 2, sc = tid & 3;
    int res[16], co[16];
    for (int p = 0; p < 16; ++p) {
      const int py = sr * 4 + (p >> 2), px = sc * 4 + (p & 3);
      res[p] = s.o[py * 16 + px] - pred.luma(s, py, px);
    }
    fdct4x4(res, co);
    s.walsh[tid] = co[0];
    co[0] = 0;
    if (trellis) {
      for (int p = 0; p < 16; ++p) s.wco[tid][p] = co[p];  // unquantized
      const TrellisNodes n = trellis_backward(s.wco[tid], ydc, yac, tcy,
                                              a.vcost, 1, a.rm, a.dm);
      s.tsel[tid] = trellis_bits(n, tcy, 1, a.rm, a.dm, end, levels);
    } else {
      quantize4x4(co, ydc, yac, s.wco[tid]);
    }
  }
  Team::sync();
  if (trellis && tid < 16) {
    // the walk of the level the contexts choose, in place
    const int ch = trellis_resolve(s.tsel, s.ctx, s.ctx + 4, 4, tid,
                                   s.wnz[tid]);
    for (int p = 0; p < 16; ++p)
      s.wco[tid][p] = trellis_coeff(s.wco[tid][p], yac, unzigzag(p), 1,
                                    ch ? end[1] : end[0],
                                    ch ? levels[1] : levels[0]);
  }
  if (tid == (trellis ? 32 : 0)) {
    int y2[16], q2[16], dq[16];
    if (trellis) {
      // Y2 in place in s.y2: shared, not a local array indexed at run time
      fwht4x4(s.walsh, s.y2);
      const int ctx = (s.ctx[16] & s.ctx[17]) + (s.ctx[18] & s.ctx[19]);
      s.y2nz = trellis_quantize(s.y2, y2dc, y2ac, a.tc + BT_Y2 * 576, a.vcost,
                                ctx, 0, a.rm, a.dm, s.y2);
      for (int p = 0; p < 16; ++p) q2[p] = s.y2[p];
    } else {
      fwht4x4(s.walsh, y2);
      quantize4x4(y2, y2dc, y2ac, q2);
      for (int p = 0; p < 16; ++p) s.y2[p] = q2[p];
    }
    dequantize4x4(q2, y2dc, y2ac, dq);
    iwht4x4(dq, s.dcv);
  }
  Team::sync();
  if (tid < 16) {
    const int sr = tid >> 2, sc = tid & 3;
    int dq[16], res[16];
    dequantize4x4(s.wco[tid], ydc, yac, dq);
    dq[0] = s.dcv[tid];
    idct4x4(dq, res);
    int pix[16];
    for (int p = 0; p < 16; ++p) {
      const int py = sr * 4 + (p >> 2), px = sc * 4 + (p & 3);
      pix[p] = clampi(pred.luma(s, py, px) + res[p], 0, 255);
    }
    // the prediction's sources (a whole mode's edges, or s.p16) are not
    // among the pixels written
    for (int p = 0; p < 16; ++p)
      Team::rec(s, sr * 4 + (p >> 2), sc * 4 + (p & 3)) = pix[p];
  }
}

// Chroma intra: the mode of least raw SSE over U and V (no rate), in
// s.dec[1].
template <typename Team = BlockTeam>
__device__ __forceinline__ void chroma_mode(MbShared& s) {
  const int tid = Team::tid(), lane = tid & 31, warp = tid >> 5;
  if (tid < 128) {
    const int pl = tid >> 6, k = tid & 63, cy = k >> 3, cx = k & 7;
    long long acc[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int pred = whole_pixel(m, s.dc[1 + pl], s.ce[pl][1 + cx],
                                   s.cl[pl][cy], s.ce[pl][0]);
      const int diff = s.oc[pl][k] - pred;
      acc[m] = diff * diff;
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      for (int o = 16; o; o >>= 1) acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], o);
      if (lane == 0) s.red[warp][m] = acc[m];
    }
  }
  Team::sync();
  if (tid == 0) {
    int um = 0;
    long long best = 0;
    for (int m = 0; m < 4; ++m) {
      const long long sse = s.red[0][m] + s.red[1][m] + s.red[2][m] + s.red[3][m];
      if (m == 0 || sse < best) { best = sse; um = m; }
    }
    s.dec[1] = um;
  }
  Team::sync();
}

// The chroma transform chain of ``pred``'s chroma (the trellis with
// ``trellis``: the 8 backward passes at once, a thread each, then each
// block's walk under its context in U's or V's independent 2x2 chain), the
// coefficients into s.uvco, the reconstruction into the planes at
// macroblock (r, c) (threads 0-7, unpublished).
template <typename Pred, typename Team = BlockTeam>
__device__ __forceinline__ void chroma_code(const MbPlanes& a, MbShared& s,
                                            int r, int c, bool trellis,
                                            Pred pred) {
  const int tid = Team::tid();
  const int uvdc = a.q[4], uvac = a.q[5];
  const int Wc = a.C * 8, cy0 = r * 8, cx0 = c * 8;
  const int* tcu = a.tc + BT_UV * 576;
  int end[2];
  unsigned levels[2];
  if (tid < 8) {
    const int pl = tid >> 2, b = tid & 3, sr = b >> 1, sc = b & 1;
    int res[16], co[16];
    for (int p = 0; p < 16; ++p) {
      const int cy = sr * 4 + (p >> 2), cx = sc * 4 + (p & 3);
      res[p] = s.oc[pl][cy * 8 + cx] - pred.chroma(s, pl, cy, cx);
    }
    fdct4x4(res, co);
    if (trellis) {
      for (int p = 0; p < 16; ++p) s.uvco[tid][p] = co[p];  // unquantized
      const TrellisNodes n = trellis_backward(s.uvco[tid], uvdc, uvac, tcu,
                                              a.vcost, 0, a.rm, a.dm);
      s.tsel[tid] = trellis_bits(n, tcu, 0, a.rm, a.dm, end, levels);
    } else {
      quantize4x4(co, uvdc, uvac, s.uvco[tid]);
    }
  }
  Team::sync();
  if (trellis && tid < 8) {
    // U and V: independent 2x2 chains, raster order
    const int pl = tid >> 2;
    const int ch = trellis_resolve(s.tsel + 4 * pl, s.ctx + 8 + 4 * pl,
                                   s.ctx + 10 + 4 * pl, 2, tid & 3,
                                   s.uvnz[tid]);
    for (int p = 0; p < 16; ++p)
      s.uvco[tid][p] = trellis_coeff(s.uvco[tid][p], p ? uvac : uvdc,
                                     unzigzag(p), 0, ch ? end[1] : end[0],
                                     ch ? levels[1] : levels[0]);
  }
  Team::sync();
  if (tid < 8) {
    const int pl = tid >> 2, b = tid & 3, sr = b >> 1, sc = b & 1;
    int dq[16], res[16];
    dequantize4x4(s.uvco[tid], uvdc, uvac, dq);
    idct4x4(dq, res);
    uint8_t* P = pl ? a.rv : a.ru;
    for (int p = 0; p < 16; ++p) {
      const int cy = sr * 4 + (p >> 2), cx = sc * 4 + (p & 3);
      P[(size_t)(cy0 + cy) * Wc + cx0 + cx] =
          (uint8_t)clampi(pred.chroma(s, pl, cy, cx) + res[p], 0, 255);
    }
  }
}

// The intra encode of the macroblock after mb_load and a barrier: warp 0
// runs the B_PRED candidate while warps 1-7 (SideTeam) run the whole-mode
// costs (unless ``screened``: a caller's whole_luma_costs published them),
// the whole-mode chain (its reconstruction into s.wt) and the chroma mode
// and chain, none of which reads what B_PRED writes; one block barrier
// joins them.  Returns the decision, B_PRED only if strictly cheaper: its
// luma reconstruction is the working tile's pixels, the whole mode's s.wt.
// The whole and chroma modes in s.dec; the caller writes the outputs.
__device__ __forceinline__ bool intra_mb(const MbPlanes& a, MbShared& s,
                                         int r, int c, const int* mbc,
                                         const int* bcost, bool contextual,
                                         bool trellis, bool screened) {
  if (threadIdx.x < 32) {
    bpred_candidate(a, s, mbc, bcost, contextual, trellis);
  } else {
    if (!screened) whole_luma_costs<SideTeam>(a, s, mbc);
    y2_path<WholePred, SideTeam>(a, s, trellis, WholePred{s.dec[0]});
    chroma_mode<SideTeam>(s);
    chroma_code<WholePred, SideTeam>(a, s, r, c, trellis,
                                     WholePred{s.dec[1]});
  }
  __syncthreads();
  return s.bcost < s.wcost;
}
