// encode_kf_frame (K7): the keyframe encoder's macroblock loop on the card.
// Mode decision, transforms, quantization (plain or trellis) and the
// decoder-identical reconstruction of every macroblock of a key frame, over
// anti-diagonals d = 2*row + col (reference encoder/encode_intra.cc:36-456;
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
// picks afterwards; here the 16 blocks run in raster order, each under the
// context its neighbours' final flags give.
//
// Design (simple and right first): one launch per diagonal, one block of
// 256 threads per macroblock.  The ten b-mode predictions of a sub-block
// are 160 threads (mode * 16 + pixel) with a 16-lane shuffle reduction of
// the SSE; one thread then picks the mode and runs the sub-block's
// transform chain, since the next sub-block predicts from its
// reconstruction.  Whole-mode variances are 256 threads (one a pixel) with
// a block reduction; the whole-mode transforms are 16 threads (one a
// block), the trellis chains one thread each (luma, Y2) or two (U and V
// side by side).  Neighbour state in device memory, written by earlier
// diagonals: the unfiltered reconstruction planes, the per-macroblock
// modes (b-mode context) and, for the trellis, the per-4x4 nonzero flags
// and the Y2 context chains.  Launches per call: 2*(R-1) + C.
//
// Bound: on paper device memory (the original planes in, coefficients,
// modes and reconstruction out: about 4.6 bytes per luma pixel); in
// practice the critical path: the serial chain of 16 sub-blocks per
// macroblock, each a mode search, a transform chain in one thread and two
// barriers, repeated over 2*(R-1) + C dependent launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "enc_transforms.cuh"
#include "intra_device.cuh"
#include "trellis.cuh"

#define B_PRED 4
#define MODE_WORDS 20  // ymode, uvmode, y2_coded, has_nonzero, 16 b-modes
// block types (tables.py): the token-cost table rows
#define BT_Y_AFTER_Y2 0
#define BT_Y2 1
#define BT_UV 2
#define BT_Y_WITHOUT_Y2 3

struct EncArgs {
  const uint8_t *oy, *ou, *ov;  // original planes (16R,16C), (8R,8C)
  uint8_t *ry, *ru, *rv;        // reconstruction planes, written
  int16_t* coeffs;              // (R,C,25,16) raster order
  uint8_t* modes;               // (R,C,MODE_WORDS)
  const int* mbc;               // key-frame macroblock mode costs (5)
  const int* bcost;             // b-mode costs [above][left][mode] (1000)
  const int* tc;                // (4,16,36) token costs, null: no trellis
  const int* vcost;             // (4096) value costs (trellis)
  uint8_t *ynz, *unz, *vnz;     // nonzero flags (4R,4C), (2R,2C) (trellis)
  uint8_t* y2c;                 // (R,C,4) Y2 chains: column nz, valid,
                                // row nz, valid after the MB (trellis)
  int R, C;
  int q[6];                     // y_dc, y_ac, y2_dc, y2_ac, uv_dc, uv_ac
  int rm, dm;                   // rate and distortion multipliers
};

__device__ __forceinline__ int imode_to_bmode(int m) {
  // whole mode (DC, V, H, TM) -> the b-mode neighbours see
  return m == 0 ? 0 : m == 1 ? 2 : m == 2 ? 3 : 1;
}

// One block per macroblock of diagonal d: r = r_lo + blockIdx.x, c = d - 2r.
__global__ void __launch_bounds__(256) enc_kf_diag_kernel(EncArgs a, int d,
                                                          int r_lo) {
  const int r = r_lo + blockIdx.x, c = d - 2 * r;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = a.C, W = C * 16, Wc = C * 8;
  const bool hrow = r > 0, hcol = c > 0, lastc = c == C - 1;
  const int y0 = r * 16, x0 = c * 16, cy0 = r * 8, cx0 = c * 8;
  const int mb = r * C + c;
  const bool trellis = a.tc != nullptr;
  const int ydc = a.q[0], yac = a.q[1], y2dc = a.q[2], y2ac = a.q[3];
  const int uvdc = a.q[4], uvac = a.q[5];

  __shared__ int s_o[256];        // original luma, raster
  __shared__ int s_oc[2][64];     // original U, V
  __shared__ int s_t[17][21];     // luma working tile: row 0 = above-left,
                                  // above x16, above-right x4; column 0 =
                                  // left; cell (1+y, 1+x) = pixel (y, x)
  __shared__ int s_ce[2][9];      // chroma above-left + above (U, V)
  __shared__ int s_cl[2][8];      // chroma left column
  __shared__ int s_dc[3];         // whole-block DC values: Y, U, V
  __shared__ int s_pred[10][16];  // the ten b-mode predictions of a sub-block
  __shared__ int s_sse[10];
  __shared__ int s_bm[16];        // B_PRED candidate b-modes
  __shared__ int s_nbm[8];        // above MB's bottom row, left MB's right
                                  // column of b-modes
  __shared__ int s_bco[16][16];   // B_PRED candidate coefficients
  __shared__ int s_wco[16][16];   // whole-mode luma coefficients
  __shared__ int s_walsh[16];     // whole-mode luma DCs
  __shared__ int s_y2[16];        // Y2 coefficients
  __shared__ int s_dcv[16];       // the luma DCs the decoder rebuilds
  __shared__ int s_uvco[8][16];   // U blocks 0-3, V blocks 4-7
  __shared__ uint8_t s_ctx[20];   // neighbours' trellis flags: Y above 0-3,
                                  // Y left 4-7, U above 8-9, U left 10-11,
                                  // V above 12-13, V left 14-15, Y2 column
                                  // nz/valid 16-17, Y2 row nz/valid 18-19
  __shared__ uint8_t s_bnz[16], s_wnz[16], s_uvnz[8], s_y2nz;
  __shared__ long long s_red[8][8];
  __shared__ int s_dec[3];        // use B_PRED, whole mode, chroma mode

  // ---- load: original pixels, edges, neighbour modes and flags ----
  s_o[tid] = a.oy[(size_t)(y0 + (tid >> 4)) * W + x0 + (tid & 15)];
  if (tid < 128) {
    const int pl = tid >> 6, k = tid & 63;
    s_oc[pl][k] = (pl ? a.ov : a.ou)[(size_t)(cy0 + (k >> 3)) * Wc + cx0 + (k & 7)];
  }
  const uint8_t* Yp = a.ry;
  if (tid < 16) {
    s_t[0][1 + tid] = hrow ? Yp[(size_t)(y0 - 1) * W + x0 + tid] : 127;
  } else if (tid < 20) {
    const int k = tid - 16;
    // the last column repeats the above row's last pixel
    s_t[0][17 + k] = !hrow ? 127
                     : lastc ? Yp[(size_t)(y0 - 1) * W + x0 + 15]
                             : Yp[(size_t)(y0 - 1) * W + x0 + 16 + k];
  } else if (tid == 20) {
    s_t[0][0] = !hrow ? 127 : hcol ? Yp[(size_t)(y0 - 1) * W + x0 - 1] : 129;
  } else if (tid >= 32 && tid < 48) {
    const int k = tid - 32;
    s_t[1 + k][0] = hcol ? Yp[(size_t)(y0 + k) * W + x0 - 1] : 129;
  } else if (tid >= 64 && tid < 128) {
    const int pl = (tid - 64) >> 5, k = (tid - 64) & 31;
    const uint8_t* P = pl ? a.rv : a.ru;
    if (k < 8) {
      s_ce[pl][1 + k] = hrow ? P[(size_t)(cy0 - 1) * Wc + cx0 + k] : 127;
    } else if (k == 8) {
      s_ce[pl][0] = !hrow ? 127 : hcol ? P[(size_t)(cy0 - 1) * Wc + cx0 - 1] : 129;
    } else if (k >= 16 && k < 24) {
      s_cl[pl][k - 16] = hcol ? P[(size_t)(cy0 + k - 16) * Wc + cx0 - 1] : 129;
    }
  } else if (tid >= 128 && tid < 132) {
    const int k = tid - 128;  // B_DC_PRED (0) off-frame
    s_nbm[k] = hrow ? a.modes[(size_t)(mb - C) * MODE_WORDS + 4 + 12 + k] : 0;
  } else if (tid >= 132 && tid < 136) {
    const int k = tid - 132;
    s_nbm[4 + k] = hcol ? a.modes[(size_t)(mb - 1) * MODE_WORDS + 4 + 4 * k + 3] : 0;
  } else if (tid >= 160 && tid < 180) {
    const int k = tid - 160;
    uint8_t v = 0;
    if (trellis) {
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
    s_ctx[k] = v;
  }
  __syncthreads();
  if (tid == 0) {
    int sa = 0, sl = 0;
    for (int k = 0; k < 16; ++k) { sa += s_t[0][1 + k]; sl += s_t[1 + k][0]; }
    s_dc[0] = dc_value(sa, sl, hrow, hcol, 4);
  } else if (tid == 32 || tid == 64) {
    const int pl = tid == 64;
    int sa = 0, sl = 0;
    for (int k = 0; k < 8; ++k) { sa += s_ce[pl][1 + k]; sl += s_cl[pl][k]; }
    s_dc[1 + pl] = dc_value(sa, sl, hrow, hcol, 3);
  }

  // ---- B_PRED candidate: 16 sub-blocks, reconstruction in the loop ----
  long long b_rate = a.mbc[B_PRED], b_dist = 0;  // thread 0's
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
        E[3 - k] = s_t[sr * 4 + 1 + k][sc * 4];
        E[5 + k] = s_t[sr * 4][sc * 4 + 1 + k];
        E[9 + k] = s_t[arow][sc * 4 + 5 + k];
      }
      E[4] = s_t[sr * 4][sc * 4];
      const int pred = bpred_pixel(m, E, ly, lx);
      const int diff = s_o[(sr * 4 + ly) * 16 + sc * 4 + lx] - pred;
      int v = diff * diff;
      s_pred[m][p] = pred;
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      if (p == 0) s_sse[m] = v;
    }
    __syncthreads();
    if (tid == 0) {
      const int above = sr ? s_bm[sb - 4] : s_nbm[sc];
      const int left = sc ? s_bm[sb - 1] : s_nbm[4 + sr];
      const int* rates = a.bcost + (above * 10 + left) * 10;
      int best = 0;
      long long best_cost = rdcost(rates[0], s_sse[0], a.rm, a.dm);
      for (int m = 1; m < 10; ++m) {
        const long long cost = rdcost(rates[m], s_sse[m], a.rm, a.dm);
        if (cost < best_cost) { best_cost = cost; best = m; }
      }
      s_bm[sb] = best;
      b_rate += rates[best];
      b_dist += s_sse[best];
      int res[16], co[16], qc[16];
      for (int p = 0; p < 16; ++p)
        res[p] = s_o[(sr * 4 + (p >> 2)) * 16 + sc * 4 + (p & 3)] - s_pred[best][p];
      fdct4x4(res, co);
      if (trellis) {
        const int up = sr ? s_bnz[sb - 4] : s_ctx[sc];
        const int lf = sc ? s_bnz[sb - 1] : s_ctx[4 + sr];
        s_bnz[sb] = trellis_quantize(co, ydc, yac, a.tc + BT_Y_WITHOUT_Y2 * 576,
                                     a.vcost, up + lf, 0, a.rm, a.dm, qc);
      } else {
        quantize4x4(co, ydc, yac, qc);
      }
      for (int p = 0; p < 16; ++p) s_bco[sb][p] = qc[p];
      dequantize4x4(qc, ydc, yac, co);
      idct4x4(co, res);
      for (int p = 0; p < 16; ++p)
        s_t[sr * 4 + 1 + (p >> 2)][sc * 4 + 1 + (p & 3)] =
            clampi(s_pred[best][p] + res[p], 0, 255);
    }
    __syncthreads();
  }

  // ---- whole-MB luma: DC, V, H, TM by variance (sse - s*s/256) ----
  {
    const int py = tid >> 4, px = tid & 15;
    long long acc[8];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int pred = whole_pixel(m, s_dc[0], s_t[0][1 + px], s_t[1 + py][0],
                                   s_t[0][0]);
      const int diff = s_o[tid] - pred;
      acc[m] = diff;
      acc[4 + m] = diff * diff;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      for (int o = 16; o; o >>= 1) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], o);
      if (lane == 0) s_red[warp][k] = acc[k];
    }
  }
  __syncthreads();
  if (tid == 0) {
    int wm = 0;
    long long wcost = 0;
    for (int m = 0; m < 4; ++m) {
      long long s = 0, sse = 0;
      for (int w = 0; w < 8; ++w) { s += s_red[w][m]; sse += s_red[w][4 + m]; }
      const long long cost = rdcost(a.mbc[m], sse - s * s / 256, a.rm, a.dm);
      if (m == 0 || cost < wcost) { wcost = cost; wm = m; }
    }
    s_dec[0] = rdcost(b_rate, b_dist, a.rm, a.dm) < wcost;
    s_dec[1] = wm;
  }
  __syncthreads();
  const bool use_b = s_dec[0] != 0;
  const int wm = s_dec[1];

  // ---- whole-mode transform path: 16 fDCTs, DCs through the WHT ----
  if (!use_b) {
    if (tid < 16) {
      const int sr = tid >> 2, sc = tid & 3;
      int res[16], co[16];
      for (int p = 0; p < 16; ++p) {
        const int py = sr * 4 + (p >> 2), px = sc * 4 + (p & 3);
        res[p] = s_o[py * 16 + px] -
                 whole_pixel(wm, s_dc[0], s_t[0][1 + px], s_t[1 + py][0], s_t[0][0]);
      }
      fdct4x4(res, co);
      s_walsh[tid] = co[0];
      co[0] = 0;
      if (trellis) {
        for (int p = 0; p < 16; ++p) s_wco[tid][p] = co[p];  // unquantized
      } else {
        quantize4x4(co, ydc, yac, s_wco[tid]);
      }
    }
    __syncthreads();
    if (tid == 0) {
      int y2[16], q2[16], dq[16];
      if (trellis) {
        // the 16 blocks in raster order, each under its known context
        for (int b = 0; b < 16; ++b) {
          const int sr = b >> 2, sc = b & 3;
          const int up = sr ? s_wnz[b - 4] : s_ctx[sc];
          const int lf = sc ? s_wnz[b - 1] : s_ctx[4 + sr];
          int unq[16];
          for (int p = 0; p < 16; ++p) unq[p] = s_wco[b][p];
          s_wnz[b] = trellis_quantize(unq, ydc, yac, a.tc + BT_Y_AFTER_Y2 * 576,
                                      a.vcost, up + lf, 1, a.rm, a.dm, s_wco[b]);
        }
      }
      fwht4x4(s_walsh, y2);
      if (trellis) {
        const int ctx = (s_ctx[16] & s_ctx[17]) + (s_ctx[18] & s_ctx[19]);
        s_y2nz = trellis_quantize(y2, y2dc, y2ac, a.tc + BT_Y2 * 576, a.vcost,
                                  ctx, 0, a.rm, a.dm, q2);
      } else {
        quantize4x4(y2, y2dc, y2ac, q2);
      }
      for (int p = 0; p < 16; ++p) s_y2[p] = q2[p];
      dequantize4x4(q2, y2dc, y2ac, dq);
      iwht4x4(dq, s_dcv);
    }
    __syncthreads();
    if (tid < 16) {
      const int sr = tid >> 2, sc = tid & 3;
      int dq[16], res[16];
      dequantize4x4(s_wco[tid], ydc, yac, dq);
      dq[0] = s_dcv[tid];
      idct4x4(dq, res);
      int pix[16];
      for (int p = 0; p < 16; ++p) {
        const int py = sr * 4 + (p >> 2), px = sc * 4 + (p & 3);
        pix[p] = clampi(whole_pixel(wm, s_dc[0], s_t[0][1 + px], s_t[1 + py][0],
                                    s_t[0][0]) + res[p], 0, 255);
      }
      // all 16 threads have read the edges (row 0, column 0), which the
      // reconstruction below does not touch
      for (int p = 0; p < 16; ++p)
        s_t[sr * 4 + 1 + (p >> 2)][sc * 4 + 1 + (p & 3)] = pix[p];
    }
  }

  // ---- chroma: the mode of least raw SSE over U and V (no rate) ----
  if (tid < 128) {
    const int pl = tid >> 6, k = tid & 63, cy = k >> 3, cx = k & 7;
    long long acc[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int pred = whole_pixel(m, s_dc[1 + pl], s_ce[pl][1 + cx],
                                   s_cl[pl][cy], s_ce[pl][0]);
      const int diff = s_oc[pl][k] - pred;
      acc[m] = diff * diff;
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      for (int o = 16; o; o >>= 1) acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], o);
      if (lane == 0) s_red[warp][m] = acc[m];
    }
  }
  __syncthreads();
  if (tid == 0) {
    int um = 0;
    long long best = 0;
    for (int m = 0; m < 4; ++m) {
      const long long sse = s_red[0][m] + s_red[1][m] + s_red[2][m] + s_red[3][m];
      if (m == 0 || sse < best) { best = sse; um = m; }
    }
    s_dec[2] = um;
  }
  __syncthreads();
  const int um = s_dec[2];
  if (tid < 8) {
    const int pl = tid >> 2, b = tid & 3, sr = b >> 1, sc = b & 1;
    int res[16], co[16];
    for (int p = 0; p < 16; ++p) {
      const int cy = sr * 4 + (p >> 2), cx = sc * 4 + (p & 3);
      res[p] = s_oc[pl][cy * 8 + cx] -
               whole_pixel(um, s_dc[1 + pl], s_ce[pl][1 + cx], s_cl[pl][cy], s_ce[pl][0]);
    }
    fdct4x4(res, co);
    if (trellis) {
      for (int p = 0; p < 16; ++p) s_uvco[tid][p] = co[p];  // unquantized
    } else {
      quantize4x4(co, uvdc, uvac, s_uvco[tid]);
    }
  }
  __syncthreads();
  if (trellis && tid < 2) {
    // U (thread 0) and V (thread 1): independent 2x2 chains, raster order
    const int pl = tid;
    for (int b = 0; b < 4; ++b) {
      const int sr = b >> 1, sc = b & 1;
      const int up = sr ? s_uvnz[4 * pl + b - 2] : s_ctx[8 + 4 * pl + sc];
      const int lf = sc ? s_uvnz[4 * pl + b - 1] : s_ctx[10 + 4 * pl + sr];
      int unq[16];
      for (int p = 0; p < 16; ++p) unq[p] = s_uvco[4 * pl + b][p];
      s_uvnz[4 * pl + b] = trellis_quantize(unq, uvdc, uvac, a.tc + BT_UV * 576,
                                            a.vcost, up + lf, 0, a.rm, a.dm,
                                            s_uvco[4 * pl + b]);
    }
  }
  __syncthreads();
  if (tid < 8) {
    const int pl = tid >> 2, b = tid & 3, sr = b >> 1, sc = b & 1;
    int dq[16], res[16];
    dequantize4x4(s_uvco[tid], uvdc, uvac, dq);
    idct4x4(dq, res);
    uint8_t* P = pl ? a.rv : a.ru;
    for (int p = 0; p < 16; ++p) {
      const int cy = sr * 4 + (p >> 2), cx = sc * 4 + (p & 3);
      const int pred = whole_pixel(um, s_dc[1 + pl], s_ce[pl][1 + cx],
                                   s_cl[pl][cy], s_ce[pl][0]);
      P[(size_t)(cy0 + cy) * Wc + cx0 + cx] = (uint8_t)clampi(pred + res[p], 0, 255);
    }
  }

  // ---- outputs: coefficients, modes, luma, the trellis state ----
  int any = 0;
  for (int i = tid; i < 400; i += 256) {
    const int blk = i >> 4, p = i & 15;
    int v;
    if (blk < 16) v = use_b ? s_bco[blk][p] : s_wco[blk][p];
    else if (blk < 24) v = s_uvco[blk - 16][p];
    else v = use_b ? 0 : s_y2[p];
    a.coeffs[(size_t)mb * 400 + i] = (int16_t)v;
    any |= v != 0;
  }
  a.ry[(size_t)(y0 + (tid >> 4)) * W + x0 + (tid & 15)] =
      (uint8_t)s_t[1 + (tid >> 4)][1 + (tid & 15)];
  const int has_nonzero = __syncthreads_or(any);
  uint8_t* md = a.modes + (size_t)mb * MODE_WORDS;
  if (tid < 16) {
    md[4 + tid] = (uint8_t)(use_b ? s_bm[tid] : imode_to_bmode(wm));
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
      a.ynz[(size_t)(4 * r + sr) * C4 + 4 * c + sc] = use_b ? s_bnz[b] : s_wnz[b];
    } else if (tid >= 64 && tid < 72) {
      const int k = tid - 64, pl = k >> 2, b = k & 3;
      (pl ? a.vnz : a.unz)[(size_t)(2 * r + (b >> 1)) * C2 + 2 * c + (b & 1)] = s_uvnz[k];
    } else if (tid == 96) {
      // a B_PRED macroblock has no Y2: it passes its neighbours' on
      uint8_t* y2 = a.y2c + (size_t)mb * 4;
      y2[0] = use_b ? s_ctx[16] : s_y2nz;
      y2[1] = use_b ? s_ctx[17] : 1;
      y2[2] = use_b ? s_ctx[18] : s_y2nz;
      y2[3] = use_b ? s_ctx[19] : 1;
    }
  }
}

// Enqueue the 2*(R-1) + C diagonal launches of one frame on ``stream``;
// writes the number of kernel launches issued to ``*n_launched`` and
// returns cudaGetLastError() after the last one.  ``tc`` null: plain
// quantization (then vcost and the flag buffers are not read).
extern "C" int encode_kf_frame_launch(
    const void* oy, const void* ou, const void* ov, void* ry, void* ru,
    void* rv, void* coeffs, void* modes, const void* mbc, const void* bcost,
    const void* tc, const void* vcost, void* ynz, void* unz, void* vnz,
    void* y2c, int ydc, int yac, int y2dc, int y2ac, int uvdc, int uvac,
    int rm, int dm, int R, int C, void* stream, int* n_launched) {
  EncArgs a;
  a.oy = (const uint8_t*)oy; a.ou = (const uint8_t*)ou; a.ov = (const uint8_t*)ov;
  a.ry = (uint8_t*)ry; a.ru = (uint8_t*)ru; a.rv = (uint8_t*)rv;
  a.coeffs = (int16_t*)coeffs;
  a.modes = (uint8_t*)modes;
  a.mbc = (const int*)mbc;
  a.bcost = (const int*)bcost;
  a.tc = (const int*)tc;
  a.vcost = (const int*)vcost;
  a.ynz = (uint8_t*)ynz; a.unz = (uint8_t*)unz; a.vnz = (uint8_t*)vnz;
  a.y2c = (uint8_t*)y2c;
  a.R = R; a.C = C;
  const int q[6] = {ydc, yac, y2dc, y2ac, uvdc, uvac};
  for (int i = 0; i < 6; ++i) a.q[i] = q[i];
  a.rm = rm; a.dm = dm;
  cudaStream_t st = (cudaStream_t)stream;
  int issued = 0;
  const int nd = 2 * (R - 1) + C;
  for (int d = 0; d < nd; ++d) {
    const int lo = d - C + 1;
    const int r_lo = lo > 0 ? (lo + 1) / 2 : 0;
    const int r_hi = d / 2 < R - 1 ? d / 2 : R - 1;
    const int n = r_hi - r_lo + 1;
    if (n <= 0) continue;
    enc_kf_diag_kernel<<<n, 256, 0, st>>>(a, d, r_lo);
    ++issued;
  }
  *n_launched = issued;
  return (int)cudaGetLastError();
}
