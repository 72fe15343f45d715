// Native host encode kernels of the host intra encoder
// (encoder/encode_intra_np.py): the forward 4x4 DCT of a residual, truncating
// quantization and the 4x4 inverse DCT added into a plane, C++ equivalents
// of the reference's encoder SIMD (dct_sse2.asm, idctllm_mmx.asm).
// Semantics match the numpy bodies in alfalfa_tpu_torch/encoder/
// transforms_np.py (subtract_fdct_plain, quantize_plain) and
// alfalfa_tpu_torch/decoder/reconstruct_np.py (idct_add_plain) line for
// line; the B_PRED search of the fast path's host-patched intra
// macroblocks (encoder/encode_intra_np.py encode_intra_mb) matches
// encode_intra_np.bpred_search_plain.  Copied from the JAX package's
// native/enckernel.cc, without its inter prediction, diamond search and
// SAD, which serve host encoders the port does not have.
#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

static inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

}  // namespace

extern "C" {

// forward 4x4 DCT of (block - pred) (dct.cc:45-103)
void vp8_subtract_fdct(const uint8_t *block, int bstride, const uint8_t *pred,
                       int pstride, int16_t *out16) {
  int inp[4][4];
  for (int r = 0; r < 4; r++)
    for (int c = 0; c < 4; c++)
      inp[r][c] = (int)block[r * bstride + c] - (int)pred[r * pstride + c];
  int16_t rows[4][4];
  for (int r = 0; r < 4; r++) {
    int a1 = (inp[r][0] + inp[r][3]) * 8;
    int b1 = (inp[r][1] + inp[r][2]) * 8;
    int c1 = (inp[r][1] - inp[r][2]) * 8;
    int d1 = (inp[r][0] - inp[r][3]) * 8;
    rows[r][0] = (int16_t)(a1 + b1);
    rows[r][2] = (int16_t)(a1 - b1);
    rows[r][1] = (int16_t)((c1 * 2217 + d1 * 5352 + 14500) >> 12);
    rows[r][3] = (int16_t)((d1 * 2217 - c1 * 5352 + 7500) >> 12);
  }
  for (int c = 0; c < 4; c++) {
    int a1 = rows[0][c] + rows[3][c];
    int b1 = rows[1][c] + rows[2][c];
    int c1 = rows[1][c] - rows[2][c];
    int d1 = rows[0][c] - rows[3][c];
    out16[0 * 4 + c] = (int16_t)((a1 + b1 + 7) >> 4);
    out16[2 * 4 + c] = (int16_t)((a1 - b1 + 7) >> 4);
    out16[1 * 4 + c] =
        (int16_t)(((c1 * 2217 + d1 * 5352 + 12000) >> 16) + (d1 != 0));
    out16[3 * 4 + c] = (int16_t)((d1 * 2217 - c1 * 5352 + 51000) >> 16);
  }
}

// 4x4 iDCT + add (transform.cc:100-137)
void vp8_idct_add(const int16_t *c16, uint8_t *target, int tstride) {
  int16_t inter[4][4];
  for (int col = 0; col < 4; col++) {
    int c0 = c16[0 * 4 + col], c1 = c16[1 * 4 + col];
    int c2 = c16[2 * 4 + col], c3 = c16[3 * 4 + col];
    int t0 = c0 + c2, t1 = c0 - c2;
    int t2 = ((c1 * 35468) >> 16) - (((c3 * 20091) >> 16) + c3);
    int t3 = (((c1 * 20091) >> 16) + c1) + ((c3 * 35468) >> 16);
    inter[col][0] = (int16_t)(t0 + t3);
    inter[col][1] = (int16_t)(t1 + t2);
    inter[col][2] = (int16_t)(t1 - t2);
    inter[col][3] = (int16_t)(t0 - t3);
  }
  for (int col = 0; col < 4; col++) {
    int i0 = inter[0][col], i1 = inter[1][col];
    int i2 = inter[2][col], i3 = inter[3][col];
    int t0 = i0 + i2, t1 = i0 - i2;
    int t2 = ((i1 * 35468) >> 16) - (((i3 * 20091) >> 16) + i3);
    int t3 = (((i1 * 20091) >> 16) + i1) + ((i3 * 35468) >> 16);
    int v0 = (t0 + t3 + 4) >> 3, v1 = (t1 + t2 + 4) >> 3;
    int v2 = (t1 - t2 + 4) >> 3, v3 = (t0 - t3 + 4) >> 3;
    uint8_t *row = target + col * tstride;
    row[0] = (uint8_t)clampi(row[0] + v0, 0, 255);
    row[1] = (uint8_t)clampi(row[1] + v1, 0, 255);
    row[2] = (uint8_t)clampi(row[2] + v2, 0, 255);
    row[3] = (uint8_t)clampi(row[3] + v3, 0, 255);
  }
}

// truncating quantization (quantization.cc:149-157)
void vp8_quantize(const int16_t *in16, int dc, int ac, int16_t *out16) {
  for (int i = 0; i < 16; i++) {
    int f = i == 0 ? dc : ac;
    int v = in16[i];
    int q = abs(v) / f;
    out16[i] = (int16_t)(v < 0 ? -q : q);
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// B_PRED (4x4 intra) mode search: all ten b-modes + SSE + RD pick
// (prediction.cc:479-643 semantics via reconstruct_np.intra_predict_b;
// search loop of encode_intra_np.encode_intra_mb)
// ---------------------------------------------------------------------------

namespace {

// edge rules of reconstruct_np._predictors for size-4 subblocks
static void predictors4(const uint8_t *plane, int h, int w, int stride,
                        int col4, int row4, int above[9], int left[4]) {
  for (int i = 0; i < 4; i++) left[i] = 129;
  if (col4 > 0)
    for (int i = 0; i < 4; i++)
      left[i] = plane[(size_t)(row4 * 4 + i) * stride + col4 * 4 - 1];
  for (int i = 0; i < 9; i++) above[i] = 127;
  if (row4 > 0) {
    const uint8_t *up = plane + (size_t)(row4 * 4 - 1) * stride;
    for (int i = 0; i < 4; i++) above[1 + i] = up[col4 * 4 + i];
    above[0] = (col4 > 0) ? up[col4 * 4 - 1] : 129;
  }
  // above-right (prediction.cc:141-163)
  if (row4 == 0) {
    // stays 127
  } else if (4 * (col4 + 1) >= w) {
    int v = 127;
    if (row4 >= 4)
      v = plane[(size_t)((row4 / 4) * 16 - 1) * stride + 4 * (col4 + 1) - 1];
    for (int i = 5; i < 9; i++) above[i] = v;
  } else if ((col4 % 4) == 3 && (row4 % 4) != 0) {
    if (row4 >= 4) {
      const uint8_t *up = plane + (size_t)((row4 / 4) * 16 - 1) * stride;
      for (int i = 0; i < 4; i++) above[5 + i] = up[4 * (col4 + 1) + i];
    }  // else stays 127
  } else {
    const uint8_t *up = plane + (size_t)(row4 * 4 - 1) * stride;
    for (int i = 0; i < 4; i++) above[5 + i] = up[4 * (col4 + 1) + i];
  }
}

static inline int avg2(int x, int y) { return (x + y + 1) >> 1; }
static inline int avg3(int x, int y, int z) { return (x + 2 * y + z + 2) >> 2; }

static void bpred4(int m, const int above[9], const int left[4],
                   uint8_t out[16]) {
  const int *a = above + 1;
  int al = above[0];
  int e[9];  // east(i): left[3-i] for i<=3, al at 4, a[i-5] beyond
  for (int i = 0; i < 4; i++) e[i] = left[3 - i];
  e[4] = al;
  for (int i = 5; i < 9; i++) e[i] = a[i - 5];
  int o[16];
  switch (m) {
    case 0: {  // B_DC_PRED
      int s = 4;
      for (int i = 0; i < 4; i++) s += a[i] + left[i];
      int v = s >> 3;
      for (int i = 0; i < 16; i++) o[i] = v;
      break;
    }
    case 1:  // B_TM_PRED
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++)
          o[y * 4 + x] = clampi(left[y] + a[x] - al, 0, 255);
      break;
    case 2: {  // B_VE_PRED
      int v[4] = {avg3(al, a[0], a[1]), avg3(a[0], a[1], a[2]),
                  avg3(a[1], a[2], a[3]), avg3(a[2], a[3], a[4])};
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++) o[y * 4 + x] = v[x];
      break;
    }
    case 3: {  // B_HE_PRED
      int v[4] = {avg3(al, left[0], left[1]), avg3(left[0], left[1], left[2]),
                  avg3(left[1], left[2], left[3]),
                  avg3(left[2], left[3], left[3])};
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++) o[y * 4 + x] = v[y];
      break;
    }
    case 4: {  // B_LD_PRED
      int v[7];
      for (int k = 0; k < 6; k++) v[k] = avg3(a[k], a[k + 1], a[k + 2]);
      v[6] = avg3(a[6], a[7], a[7]);
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++) o[y * 4 + x] = v[x + y];
      break;
    }
    case 5: {  // B_RD_PRED
      int v[7];
      for (int i = 0; i < 7; i++) v[i] = avg3(e[i], e[i + 1], e[i + 2]);
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++) o[y * 4 + x] = v[x - y + 3];
      break;
    }
    case 6:  // B_VR_PRED
      o[3 * 4 + 0] = avg3(e[1], e[2], e[3]);
      o[2 * 4 + 0] = avg3(e[2], e[3], e[4]);
      o[3 * 4 + 1] = o[1 * 4 + 0] = avg3(e[3], e[4], e[5]);
      o[2 * 4 + 1] = o[0 * 4 + 0] = avg2(e[4], e[5]);
      o[3 * 4 + 2] = o[1 * 4 + 1] = avg3(e[4], e[5], e[6]);
      o[2 * 4 + 2] = o[0 * 4 + 1] = avg2(e[5], e[6]);
      o[3 * 4 + 3] = o[1 * 4 + 2] = avg3(e[5], e[6], e[7]);
      o[2 * 4 + 3] = o[0 * 4 + 2] = avg2(e[6], e[7]);
      o[1 * 4 + 3] = avg3(e[6], e[7], e[8]);
      o[0 * 4 + 3] = avg2(e[7], e[8]);
      break;
    case 7:  // B_VL_PRED
      o[0 * 4 + 0] = avg2(a[0], a[1]);
      o[1 * 4 + 0] = avg3(a[0], a[1], a[2]);
      o[2 * 4 + 0] = o[0 * 4 + 1] = avg2(a[1], a[2]);
      o[1 * 4 + 1] = o[3 * 4 + 0] = avg3(a[1], a[2], a[3]);
      o[2 * 4 + 1] = o[0 * 4 + 2] = avg2(a[2], a[3]);
      o[3 * 4 + 1] = o[1 * 4 + 2] = avg3(a[2], a[3], a[4]);
      o[2 * 4 + 2] = o[0 * 4 + 3] = avg2(a[3], a[4]);
      o[3 * 4 + 2] = o[1 * 4 + 3] = avg3(a[3], a[4], a[5]);
      o[2 * 4 + 3] = avg3(a[4], a[5], a[6]);
      o[3 * 4 + 3] = avg3(a[5], a[6], a[7]);
      break;
    case 8:  // B_HD_PRED
      o[3 * 4 + 0] = avg2(e[0], e[1]);
      o[3 * 4 + 1] = avg3(e[0], e[1], e[2]);
      o[2 * 4 + 0] = o[3 * 4 + 2] = avg2(e[1], e[2]);
      o[2 * 4 + 1] = o[3 * 4 + 3] = avg3(e[1], e[2], e[3]);
      o[2 * 4 + 2] = o[1 * 4 + 0] = avg2(e[2], e[3]);
      o[2 * 4 + 3] = o[1 * 4 + 1] = avg3(e[2], e[3], e[4]);
      o[1 * 4 + 2] = o[0 * 4 + 0] = avg2(e[3], e[4]);
      o[1 * 4 + 3] = o[0 * 4 + 1] = avg3(e[3], e[4], e[5]);
      o[0 * 4 + 2] = avg3(e[4], e[5], e[6]);
      o[0 * 4 + 3] = avg3(e[5], e[6], e[7]);
      break;
    default:  // 9: B_HU_PRED
      o[0 * 4 + 0] = avg2(left[0], left[1]);
      o[0 * 4 + 1] = avg3(left[0], left[1], left[2]);
      o[1 * 4 + 0] = o[0 * 4 + 2] = avg2(left[1], left[2]);
      o[1 * 4 + 1] = o[0 * 4 + 3] = avg3(left[1], left[2], left[3]);
      o[1 * 4 + 2] = o[2 * 4 + 0] = avg2(left[2], left[3]);
      o[1 * 4 + 3] = o[2 * 4 + 1] = avg3(left[2], left[3], left[3]);
      o[2 * 4 + 2] = o[2 * 4 + 3] = o[3 * 4 + 0] = o[3 * 4 + 1] =
          o[3 * 4 + 2] = o[3 * 4 + 3] = left[3];
      break;
  }
  for (int i = 0; i < 16; i++) out[i] = (uint8_t)o[i];
}

}  // namespace

extern "C" {

// Search all 10 b-modes for one subblock; writes the winning prediction
// into pred16 and returns the mode.  Cost/selection math matches
// encode_intra_np (rdcost with strict less, mode order 0..9).
int vp8_bpred_search(const uint8_t *plane, int h, int w, int stride,
                     int col4, int row4, const uint8_t *orig, int orig_stride,
                     const int64_t *mode_costs, int64_t rate_mult,
                     int64_t dist_mult, uint8_t *pred16) {
  int above[9], left[4];
  predictors4(plane, h, w, stride, col4, row4, above, left);
  uint8_t cand[16];
  long long best_cost = -1;
  int best_mode = 0;
  for (int m = 0; m < 10; m++) {
    bpred4(m, above, left, cand);
    long long sse = 0;
    for (int y = 0; y < 4; y++)
      for (int x = 0; x < 4; x++) {
        int d = (int)orig[y * orig_stride + x] - (int)cand[y * 4 + x];
        sse += d * d;
      }
    long long cost =
        (128 + mode_costs[m] * rate_mult) / 256 + sse * dist_mult;
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best_mode = m;
      memcpy(pred16, cand, 16);
    }
  }
  return best_mode;
}

// Predict one b-mode subblock into out16 (no plane write).
void vp8_bpred_predict(const uint8_t *plane, int h, int w, int stride,
                       int col4, int row4, int mode, uint8_t *out16) {
  int above[9], left[4];
  predictors4(plane, h, w, stride, col4, row4, above, left);
  bpred4(mode, above, left, out16);
}

}  // extern "C"
