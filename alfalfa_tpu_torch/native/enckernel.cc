// Native host encode kernels of the rebase's intra macroblocks
// (encoder/reencode.py): the forward 4x4 DCT of a residual, truncating
// quantization and the 4x4 inverse DCT added into a plane, C++ equivalents
// of the reference's encoder SIMD (dct_sse2.asm, idctllm_mmx.asm).
// Semantics match the numpy bodies in alfalfa_tpu_torch/encoder/
// transforms_np.py (subtract_fdct_plain, quantize_plain) and
// alfalfa_tpu_torch/decoder/reconstruct_np.py (idct_add_plain) line for
// line.  Copied from the JAX package's native/enckernel.cc, without its
// inter prediction, diamond search, SAD and B_PRED search, which serve
// host encoders the port does not have.
#include <cstdint>
#include <cstdlib>

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
