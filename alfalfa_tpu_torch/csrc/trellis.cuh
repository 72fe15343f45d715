// H2: trellis (RD-optimal) quantization of one 4x4 block in one thread, the
// --two-pass encoder's quantizer (reference encoder/encoder.cc:221-408; the
// JAX package's host twin encoder/trellis.py:trellis_quantize; the plain
// version ops/trellis.py).  A 2-level Viterbi walks the 16 zigzag
// positions backwards, choosing between the quantized level q and q-1 per
// coefficient by rate (token costs under the frame's probabilities plus
// the value's sign and extra-bit cost) + distortion, then walks the chosen
// path forward under the block's known entry context.
//
// Replaces alfalfa_tpu/ops/trellis_pallas.py:trellis_quantize_pm (with its
// trellis_nodes:161, final_costs:263, choose_level:275, trellis_walk:282),
// which lays positions across TPU lanes and, for whole-macroblock luma,
// runs all 16 blocks' walks under all three entry contexts and picks
// afterwards.  Here the caller runs the blocks of a macroblock in raster
// order, each with the entry context its neighbours' final flags give.
// Costs are int64 like the reference's (no int32 headroom argument).
//
// Tables (device memory): tc, this block type's (16, 36) position-major
// token costs, tc[idx * 36 + ctx * 12 + token] (encoder/trellis.py:
// token_costs_pm); vcost, the 4096 value costs, vcost[2048 + v].

#pragma once

#include <stdint.h>

#define TRELLIS_EOB 11

__constant__ uint8_t c_zigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6,
                                     9, 12, 13, 10, 7, 11, 14, 15};

__device__ __forceinline__ long long rdcost(long long rate, long long dist,
                                            int rm, int dm) {
  return ((128 + rate * rm) >> 8) + dist * dm;
}

// Token of a coefficient magnitude (encoder/costs.cc:242-261).
__device__ __forceinline__ int token_of(int mag) {
  if (mag <= 4) return mag;
  if (mag <= 6) return 5;
  if (mag <= 10) return 6;
  if (mag <= 18) return 7;
  if (mag <= 34) return 8;
  if (mag <= 66) return 9;
  return 10;
}

// Quantize the raster-order unquantized coefficients unq into out from
// position ``first`` (1 for luma blocks whose DC went to Y2) with entry
// context ctx (0..2).  Returns whether any output coefficient is nonzero.
__device__ bool trellis_quantize(const int* unq, int dcf, int acf,
                                 const int* __restrict__ tc,
                                 const int* __restrict__ vcost, int ctx,
                                 int first, int rm, int dm, int* out) {
  int coeff[16][2];
  uint8_t token[16][2], nxt[16][2];
  int cl = 0;  // coded length: one past the last nonzero position
  for (int idx = 0; idx < 16; ++idx) {
    token[idx][0] = token[idx][1] = TRELLIS_EOB;
    nxt[idx][0] = nxt[idx][1] = 255;
    coeff[idx][0] = coeff[idx][1] = 0;
    if (idx >= first && unq[c_zigzag[idx]] != 0) cl = idx + 1;
  }
  // the node after the current position, per level: rate, distortion,
  // token (positions from cl on keep the initial end-of-block node)
  long long rate[2] = {0, 0}, dist[2] = {0, 0};
  int tok[2] = {TRELLIS_EOB, TRELLIS_EOB};
  for (int idx = cl - 1; idx >= first; --idx) {
    const int o = unq[c_zigzag[idx]];
    const int f = idx ? acf : dcf;
    const int qm = (o < 0 ? -o : o) / f;
    long long n_rate[2], n_dist[2];
    int n_tok[2];
    for (int s = 0; s < 2; ++s) {
      // level q (s = 0) or one step toward zero (s = 1; 0 stays 0)
      const int mag = qm - s > 0 ? qm - s : 0;
      const int cand = o < 0 ? -mag : mag;
      const long long diff = (long long)o - (long long)cand * f;
      const long long sse = diff * diff;
      const int tk = token_of(mag);
      const int cls = mag < 2 ? mag : 2;
      long long r[2], d[2], rd[2];
      for (int n = 0; n < 2; ++n) {
        d[n] = dist[n] + sse;
        r[n] = rate[n] + (idx < 15 ? tc[(idx + 1) * 36 + cls * 12 + tok[n]] : 0);
        rd[n] = rdcost(r[n], d[n], rm, dm);
      }
      const int bn = rd[1] < rd[0];  // ties -> level 0
      if (mag == 0 && tok[bn] == TRELLIS_EOB) {
        // a zero before the end of block: pull the end of block forward
        n_rate[s] = 0;
        n_dist[s] = sse;
        n_tok[s] = TRELLIS_EOB;
        nxt[idx][s] = 255;
        coeff[idx][s] = 0;
      } else {
        n_rate[s] = r[bn] + vcost[2048 + cand];
        n_dist[s] = d[bn];
        n_tok[s] = tk;
        nxt[idx][s] = (uint8_t)bn;
        coeff[idx][s] = cand;
      }
      token[idx][s] = (uint8_t)n_tok[s];
    }
    for (int s = 0; s < 2; ++s) {
      rate[s] = n_rate[s];
      dist[s] = n_dist[s];
      tok[s] = n_tok[s];
    }
  }
  // charge the first token under the entry context; ties -> level 0
  const int* row = tc + first * 36 + ctx * 12;
  int ch = rdcost(rate[1] + row[tok[1]], dist[1], rm, dm) <
           rdcost(rate[0] + row[tok[0]], dist[0], rm, dm);
  bool nz = false;
  for (int i = 0; i < 16; ++i) out[i] = 0;
  for (int idx = first; idx < 16; ++idx) {
    if (token[idx][ch] == TRELLIS_EOB) break;
    const int v = coeff[idx][ch];
    out[c_zigzag[idx]] = v;
    nz |= v != 0;
    ch = nxt[idx][ch];
  }
  return nz;
}
