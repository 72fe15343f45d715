// Macroblock encode steps shared by the key-frame encoder (enc_intra.cu:
// K7), the interframe encoder (enc_inter.cu: K8) and the fast path's intra
// fixup (enc_intra_fixup.cu: K10, whole modes only): the loads of a
// macroblock's originals and reconstructed edges, the whole-mode luma
// costs, the B_PRED candidate with reconstruction in the loop (contextual
// key-frame b-mode costs or the interframe's non-contextual ones), the
// luma Y2 path and the chroma mode search and transform chain, each with
// plain or trellis quantization.  One block of 256 threads runs one
// macroblock; every step is called by all its threads, and each says what
// its last phase leaves unpublished (a barrier costs a K7 or K8 launch about
// as much as a small step, so there is no barrier a caller does not need).
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
  int (&pc)[2][64];       // the chroma predictions the chroma chain codes
  int (&pred)[10][16];    // the ten b-mode predictions of a sub-block
  int (&sse)[10];
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
  uint8_t& y2nz;
  long long (&red)[8][8];
  long long& wcost;       // the best whole-mode cost
  long long& bcost;       // the B_PRED candidate's cost
  int (&dec)[3];          // use B_PRED, whole mode, chroma mode
};

// Declares the shared arrays of one macroblock's state and ``s``, the
// MbShared over them (arrays a kernel never reads take no memory).
#define MB_SHARED(s)                                                      \
  __shared__ int s##_o[256], s##_oc[2][64], s##_t[17][21], s##_ce[2][9],  \
      s##_cl[2][8], s##_dc[3], s##_p16[256], s##_pc[2][64],               \
      s##_pred[10][16], s##_sse[10], s##_bm[16], s##_nbm[8],              \
      s##_bco[16][16], s##_wco[16][16], s##_walsh[16], s##_y2[16],        \
      s##_dcv[16], s##_uvco[8][16], s##_dec[3];                           \
  __shared__ uint8_t s##_ctx[20], s##_bnz[16], s##_wnz[16], s##_uvnz[8],  \
      s##_y2nz;                                                           \
  __shared__ long long s##_red[8][8], s##_wcost, s##_bcost;               \
  MbShared s{s##_o,    s##_oc,   s##_t,    s##_ce,   s##_cl,   s##_dc,    \
             s##_p16,  s##_pc,   s##_pred, s##_sse,  s##_bm,   s##_nbm,   \
             s##_bco,  s##_wco,  s##_walsh, s##_y2,  s##_dcv,  s##_uvco,  \
             s##_ctx,  s##_bnz,  s##_wnz,  s##_uvnz, s##_y2nz, s##_red,   \
             s##_wcost, s##_bcost, s##_dec}

__device__ __forceinline__ int imode_to_bmode(int m) {
  // whole mode (DC, V, H, TM) -> the b-mode neighbours see
  return m == 0 ? 0 : m == 1 ? 2 : m == 2 ? 3 : 1;
}

// The originals of macroblock (r, c), its edges in the reconstruction, the
// neighbours' trellis flags (with a.tc), then the three DC values.  Leaves
// threads 128-159 and 180-255 free for the caller's own loads before the
// call, whose barrier publishes them.  The DC values (threads 0, 32, 64)
// are published by the caller's next barrier: the B_PRED candidate does
// not read them.
__device__ __forceinline__ void mb_load(const MbPlanes& a, MbShared& s,
                                        int r, int c) {
  const int tid = threadIdx.x;
  const int C = a.C, W = C * 16, Wc = C * 8;
  const bool hrow = r > 0, hcol = c > 0, lastc = c == C - 1;
  const int y0 = r * 16, x0 = c * 16, cy0 = r * 8, cx0 = c * 8;
  const int mb = r * C + c;
  s.o[tid] = a.oy[(size_t)(y0 + (tid >> 4)) * W + x0 + (tid & 15)];
  if (tid < 128) {
    const int pl = tid >> 6, k = tid & 63;
    s.oc[pl][k] = (pl ? a.ov : a.ou)[(size_t)(cy0 + (k >> 3)) * Wc + cx0 + (k & 7)];
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
// mbc[0..3]: the first of least cost in s.dec[1], its cost in s.wcost;
// after the B_PRED candidate (``bpred``) also the decision in s.dec[0]:
// B_PRED only if strictly cheaper.  With ``start`` >= 0 the scan starts
// from that cost instead of DC's (the fast path's INF: a mode costing it or
// more is never taken, and DC is kept if all do).
__device__ __forceinline__ void whole_luma_costs(const MbPlanes& a,
                                                 MbShared& s, const int* mbc,
                                                 bool bpred,
                                                 long long start = -1) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  {
    const int py = tid >> 4, px = tid & 15;
    long long acc[8];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int pred = whole_pixel(m, s.dc[0], s.t[0][1 + px], s.t[1 + py][0],
                                   s.t[0][0]);
      const int diff = s.o[tid] - pred;
      acc[m] = diff;
      acc[4 + m] = diff * diff;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      for (int o = 16; o; o >>= 1) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], o);
      if (lane == 0) s.red[warp][k] = acc[k];
    }
  }
  __syncthreads();
  if (tid == 0) {
    int wm = 0;
    long long wcost = start;
    for (int m = 0; m < 4; ++m) {
      long long sm = 0, sse = 0;
      for (int w = 0; w < 8; ++w) { sm += s.red[w][m]; sse += s.red[w][4 + m]; }
      const long long cost = rdcost(mbc[m], sse - sm * sm / 256, a.rm, a.dm);
      if ((m == 0 && start < 0) || cost < wcost) { wcost = cost; wm = m; }
    }
    s.dec[0] = bpred && s.bcost < wcost;
    s.dec[1] = wm;
    s.wcost = wcost;
  }
  __syncthreads();
}

// The B_PRED candidate: the 16 sub-blocks in raster order, each scoring
// the ten b-modes by SSE rd-cost, then its transform chain into the
// working tile the next sub-block predicts from.  b-mode rates: with
// ``contextual``, bcost[(above * 10 + left) * 10 + mode] under the
// neighbours' modes (s.nbm off the macroblock); else bcost[mode].  Its
// rd-cost in s.bcost (thread 0's, unpublished); modes, coefficients, flags
// in s.bm, s.bco, s.bnz.
__device__ __forceinline__ void bpred_candidate(const MbPlanes& a,
                                                MbShared& s, const int* mbc,
                                                const int* bcost,
                                                bool contextual) {
  const int tid = threadIdx.x;
  const bool trellis = a.tc != nullptr;
  const int ydc = a.q[0], yac = a.q[1];
  long long b_rate = mbc[B_PRED], b_dist = 0;  // thread 0's
  for (int sb = 0; sb < 16; ++sb) {
    const int sr = sb >> 2, sc = sb & 3;
    if (tid < 160) {
      const int m = tid >> 4, p = tid & 15, ly = p >> 2, lx = p & 3;
      int E[13];
      // the right-most sub-block takes its above-right from the row above
      // the macroblock in every sub-block row
      const int arow = sc == 3 ? 0 : sr * 4;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        E[3 - k] = s.t[sr * 4 + 1 + k][sc * 4];
        E[5 + k] = s.t[sr * 4][sc * 4 + 1 + k];
        E[9 + k] = s.t[arow][sc * 4 + 5 + k];
      }
      E[4] = s.t[sr * 4][sc * 4];
      const int pred = bpred_pixel(m, E, ly, lx);
      const int diff = s.o[(sr * 4 + ly) * 16 + sc * 4 + lx] - pred;
      int v = diff * diff;
      s.pred[m][p] = pred;
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      if (p == 0) s.sse[m] = v;
    }
    __syncthreads();
    if (tid == 0) {
      const int* rates = bcost;
      if (contextual) {
        const int above = sr ? s.bm[sb - 4] : s.nbm[sc];
        const int left = sc ? s.bm[sb - 1] : s.nbm[4 + sr];
        rates = bcost + (above * 10 + left) * 10;
      }
      int best = 0;
      long long best_cost = rdcost(rates[0], s.sse[0], a.rm, a.dm);
      for (int m = 1; m < 10; ++m) {
        const long long cost = rdcost(rates[m], s.sse[m], a.rm, a.dm);
        if (cost < best_cost) { best_cost = cost; best = m; }
      }
      s.bm[sb] = best;
      b_rate += rates[best];
      b_dist += s.sse[best];
      int res[16], co[16], qc[16];
      for (int p = 0; p < 16; ++p)
        res[p] = s.o[(sr * 4 + (p >> 2)) * 16 + sc * 4 + (p & 3)] - s.pred[best][p];
      fdct4x4(res, co);
      if (trellis) {
        const int up = sr ? s.bnz[sb - 4] : s.ctx[sc];
        const int lf = sc ? s.bnz[sb - 1] : s.ctx[4 + sr];
        s.bnz[sb] = trellis_quantize(co, ydc, yac, a.tc + BT_Y_WITHOUT_Y2 * 576,
                                     a.vcost, up + lf, 0, a.rm, a.dm, qc);
      } else {
        quantize4x4(co, ydc, yac, qc);
      }
      for (int p = 0; p < 16; ++p) s.bco[sb][p] = qc[p];
      dequantize4x4(qc, ydc, yac, co);
      idct4x4(co, res);
      for (int p = 0; p < 16; ++p)
        s.t[sr * 4 + 1 + (p >> 2)][sc * 4 + 1 + (p & 3)] =
            clampi(s.pred[best][p] + res[p], 0, 255);
    }
    __syncthreads();
  }
  if (tid == 0) s.bcost = rdcost(b_rate, b_dist, a.rm, a.dm);
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

// The whole-macroblock luma chain of ``pred``'s luma: 16 fDCTs, their DCs
// through the WHT into Y2, quantization (the trellis with ``trellis``: the
// 16 blocks in raster order under their known contexts, then Y2 under its
// chains), and the decoder's reconstruction into the working tile's pixels
// (threads 0-15, unpublished).
template <typename Pred>
__device__ __forceinline__ void y2_path(const MbPlanes& a, MbShared& s,
                                        bool trellis, Pred pred) {
  const int tid = threadIdx.x;
  const int ydc = a.q[0], yac = a.q[1], y2dc = a.q[2], y2ac = a.q[3];
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
    } else {
      quantize4x4(co, ydc, yac, s.wco[tid]);
    }
  }
  __syncthreads();
  if (tid == 0) {
    int y2[16], q2[16], dq[16];
    if (trellis) {
      for (int b = 0; b < 16; ++b) {
        const int sr = b >> 2, sc = b & 3;
        const int up = sr ? s.wnz[b - 4] : s.ctx[sc];
        const int lf = sc ? s.wnz[b - 1] : s.ctx[4 + sr];
        int unq[16];
        for (int p = 0; p < 16; ++p) unq[p] = s.wco[b][p];
        s.wnz[b] = trellis_quantize(unq, ydc, yac, a.tc + BT_Y_AFTER_Y2 * 576,
                                    a.vcost, up + lf, 1, a.rm, a.dm, s.wco[b]);
      }
    }
    fwht4x4(s.walsh, y2);
    if (trellis) {
      const int ctx = (s.ctx[16] & s.ctx[17]) + (s.ctx[18] & s.ctx[19]);
      s.y2nz = trellis_quantize(y2, y2dc, y2ac, a.tc + BT_Y2 * 576, a.vcost,
                                ctx, 0, a.rm, a.dm, q2);
    } else {
      quantize4x4(y2, y2dc, y2ac, q2);
    }
    for (int p = 0; p < 16; ++p) s.y2[p] = q2[p];
    dequantize4x4(q2, y2dc, y2ac, dq);
    iwht4x4(dq, s.dcv);
  }
  __syncthreads();
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
      s.t[sr * 4 + 1 + (p >> 2)][sc * 4 + 1 + (p & 3)] = pix[p];
  }
}

// Chroma intra: the mode of least raw SSE over U and V (no rate), in
// s.dec[2].
__device__ __forceinline__ void chroma_mode(MbShared& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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
  __syncthreads();
  if (tid == 0) {
    int um = 0;
    long long best = 0;
    for (int m = 0; m < 4; ++m) {
      const long long sse = s.red[0][m] + s.red[1][m] + s.red[2][m] + s.red[3][m];
      if (m == 0 || sse < best) { best = sse; um = m; }
    }
    s.dec[2] = um;
  }
  __syncthreads();
}

// The chroma transform chain of ``pred``'s chroma (the trellis with
// ``trellis``: U and V as independent 2x2 chains in raster order), the
// coefficients into s.uvco, the reconstruction into the planes at
// macroblock (r, c) (threads 0-7, unpublished).
template <typename Pred>
__device__ __forceinline__ void chroma_code(const MbPlanes& a, MbShared& s,
                                            int r, int c, bool trellis,
                                            Pred pred) {
  const int tid = threadIdx.x;
  const int uvdc = a.q[4], uvac = a.q[5];
  const int Wc = a.C * 8, cy0 = r * 8, cx0 = c * 8;
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
    } else {
      quantize4x4(co, uvdc, uvac, s.uvco[tid]);
    }
  }
  __syncthreads();
  if (trellis && tid < 2) {
    // U (thread 0) and V (thread 1): independent 2x2 chains, raster order
    const int pl = tid;
    for (int b = 0; b < 4; ++b) {
      const int sr = b >> 1, sc = b & 1;
      const int up = sr ? s.uvnz[4 * pl + b - 2] : s.ctx[8 + 4 * pl + sc];
      const int lf = sc ? s.uvnz[4 * pl + b - 1] : s.ctx[10 + 4 * pl + sr];
      int unq[16];
      for (int p = 0; p < 16; ++p) unq[p] = s.uvco[4 * pl + b][p];
      s.uvnz[4 * pl + b] = trellis_quantize(unq, uvdc, uvac, a.tc + BT_UV * 576,
                                            a.vcost, up + lf, 0, a.rm, a.dm,
                                            s.uvco[4 * pl + b]);
    }
  }
  __syncthreads();
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

// The full intra encode of the macroblock after mb_load: B_PRED candidate,
// whole-mode costs, the decision (B_PRED only if strictly cheaper), the
// whole-mode chain where it won, chroma.  Results in s (s.dec[0] = use
// B_PRED); the caller writes the outputs.
__device__ __forceinline__ void intra_mb(const MbPlanes& a, MbShared& s,
                                         int r, int c, const int* mbc,
                                         const int* bcost, bool contextual) {
  const bool trellis = a.tc != nullptr;
  bpred_candidate(a, s, mbc, bcost, contextual);
  whole_luma_costs(a, s, mbc, true);
  if (!s.dec[0]) y2_path(a, s, trellis, WholePred{s.dec[1]});
  chroma_mode(s);
  chroma_code(a, s, r, c, trellis, WholePred{s.dec[2]});
}
