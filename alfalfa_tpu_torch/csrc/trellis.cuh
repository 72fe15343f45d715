// H2: trellis (RD-optimal) quantization of one 4x4 block, the --two-pass
// encoder's quantizer (reference encoder/encoder.cc:221-408; the JAX
// package's host twin encoder/trellis.py:trellis_quantize; the plain
// version ops/trellis.py).  A 2-level Viterbi walks the 16 zigzag
// positions backwards, choosing between the quantized level q and q-1 per
// coefficient by rate (token costs under the frame's probabilities plus
// the value's sign and extra-bit cost) + distortion, then walks the chosen
// path forward under the block's entry context.
//
// Replaces alfalfa_tpu/ops/trellis_pallas.py:trellis_quantize_pm (with its
// trellis_nodes:161, final_costs:263, choose_level:275, trellis_walk:282),
// which lays positions across TPU lanes and, for whole-macroblock luma,
// runs all 16 blocks' walks under all three entry contexts and picks
// afterwards.  Here the pass is split the same way: trellis_backward
// (the nodes, which do not depend on the entry context), trellis_choose
// (the start level under a context), trellis_path (the walk from a start
// level) and trellis_coeff (one coefficient of a walk).  Blocks whose
// contexts chain (whole-macroblock luma, chroma) run their backward passes
// on a thread each and resolve the contexts in raster order afterwards
// with the cheap choice alone; trellis_quantize is the one-call form.
// Costs are int64 like the reference's (no int32 headroom argument).  The
// per-position state is bits in registers (no array indexed at run time,
// so nothing lands in local memory); the coefficients are read where the
// caller keeps them.
//
// Tables (device memory): tc, this block type's (16, 36) position-major
// token costs, tc[idx * 36 + ctx * 12 + token] (encoder/trellis.py:
// token_costs_pm); vcost, the 4096 value costs, vcost[2048 + v].

#pragma once

#include <stdint.h>

#define TRELLIS_EOB 11

// zigzag index -> raster position, and back, as packed nibbles
#define ZIGZAG_PACKED 0xfeb7adc963258410ull
#define UNZIGZAG_PACKED 0xfea9db83c7426510ull

__device__ __forceinline__ int zigzag(int idx) {
  return (int)((ZIGZAG_PACKED >> (4 * idx)) & 15);
}
__device__ __forceinline__ int unzigzag(int pos) {
  return (int)((UNZIGZAG_PACKED >> (4 * pos)) & 15);
}

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

// The backward pass's result: the first node of each start level's path
// (rate, distortion, token) and, per position idx and level s, bit
// 2 * idx + s of ``stop`` (the path ends there: end of block) and of
// ``next`` (the level at idx + 1).  Bit idx of q1 / q2: the quantized
// magnitude there is at least 1 / 2.
struct TrellisNodes {
  long long rate[2], dist[2];
  int tok[2];
  unsigned stop, next, q1, q2;
};

// The backward pass over the raster-order unquantized coefficients unq,
// from position ``first`` (1 for luma blocks whose DC went to Y2).
__device__ __forceinline__ TrellisNodes trellis_backward(
    const int* unq, int dcf, int acf, const int* __restrict__ tc,
    const int* __restrict__ vcost, int first, int rm, int dm) {
  TrellisNodes n;
  int cl = 0;  // coded length: one past the last nonzero position
  n.q1 = n.q2 = 0;
  for (int idx = first; idx < 16; ++idx)
    if (unq[zigzag(idx)] != 0) cl = idx + 1;
  // positions from cl on keep the initial end-of-block node
  n.rate[0] = n.rate[1] = 0;
  n.dist[0] = n.dist[1] = 0;
  n.tok[0] = n.tok[1] = TRELLIS_EOB;
  n.stop = 0xffffffffu;
  n.next = 0;
  for (int idx = cl - 1; idx >= first; --idx) {
    const int o = unq[zigzag(idx)];
    const int f = idx ? acf : dcf;
    const int qm = (o < 0 ? -o : o) / f;
    n.q1 |= (unsigned)(qm >= 1) << idx;
    n.q2 |= (unsigned)(qm >= 2) << idx;
    long long n_rate[2], n_dist[2];
    int n_tok[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      // level q (s = 0) or one step toward zero (s = 1; 0 stays 0)
      const int mag = qm - s > 0 ? qm - s : 0;
      const int cand = o < 0 ? -mag : mag;
      const long long diff = (long long)o - (long long)cand * f;
      const long long sse = diff * diff;
      const int cls = mag < 2 ? mag : 2;
      long long r[2], d[2], rd[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        d[k] = n.dist[k] + sse;
        r[k] = n.rate[k] + (idx < 15 ? tc[(idx + 1) * 36 + cls * 12 + n.tok[k]] : 0);
        rd[k] = rdcost(r[k], d[k], rm, dm);
      }
      const int bn = rd[1] < rd[0];  // ties -> level 0
      // selects, not r[bn]: an index known only at run time would put the
      // arrays in local memory
      if (mag == 0 && (bn ? n.tok[1] : n.tok[0]) == TRELLIS_EOB) {
        // a zero before the end of block: pull the end of block forward
        n_rate[s] = 0;
        n_dist[s] = sse;
        n_tok[s] = TRELLIS_EOB;
      } else {
        n_rate[s] = (bn ? r[1] : r[0]) + vcost[2048 + cand];
        n_dist[s] = bn ? d[1] : d[0];
        n_tok[s] = token_of(mag);
        n.stop &= ~(1u << (2 * idx + s));
        n.next |= (unsigned)bn << (2 * idx + s);
      }
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      n.rate[s] = n_rate[s];
      n.dist[s] = n_dist[s];
      n.tok[s] = n_tok[s];
    }
  }
  return n;
}

// The start level under entry context ctx (0..2): the first token charged
// under it; ties -> level 0.
__device__ __forceinline__ int trellis_choose(const TrellisNodes& n,
                                              const int* __restrict__ tc,
                                              int first, int ctx, int rm,
                                              int dm) {
  const int* row = tc + first * 36 + ctx * 12;
  return rdcost(n.rate[1] + row[n.tok[1]], n.dist[1], rm, dm) <
         rdcost(n.rate[0] + row[n.tok[0]], n.dist[0], rm, dm);
}

// The walk from start level ``ch``: returns its end (the first zigzag
// index not coded); bit idx of ``levels`` is the level taken at idx.
__device__ __forceinline__ int trellis_path(const TrellisNodes& n, int first,
                                            int ch, unsigned& levels) {
  levels = 0;
  int idx = first;
  for (; idx < 16; ++idx) {
    const int bit = 2 * idx + ch;
    if ((n.stop >> bit) & 1) break;
    levels |= (unsigned)ch << idx;
    ch = (n.next >> bit) & 1;
  }
  return idx;
}

// Whether the walk (end, levels) codes a nonzero coefficient.
__device__ __forceinline__ bool trellis_nonzero(const TrellisNodes& n,
                                                int first, int end,
                                                unsigned levels) {
  const unsigned coded = ((1u << end) - 1) & ~((1u << first) - 1);
  return ((n.q2 | (n.q1 & ~levels)) & coded) != 0;
}

// The coefficient at zigzag index idx of the walk (end, levels), from its
// unquantized value o and factor f.
__device__ __forceinline__ int trellis_coeff(int o, int f, int idx, int first,
                                             int end, unsigned levels) {
  if (idx < first || idx >= end) return 0;
  const int qm = (o < 0 ? -o : o) / f - (int)((levels >> idx) & 1);
  const int mag = qm > 0 ? qm : 0;
  return o < 0 ? -mag : mag;
}

// The one-call form: quantize unq into out (which may be unq itself) with
// entry context ctx; returns whether any output coefficient is nonzero.
__device__ __forceinline__ bool trellis_quantize(
    const int* unq, int dcf, int acf, const int* __restrict__ tc,
    const int* __restrict__ vcost, int ctx, int first, int rm, int dm,
    int* out) {
  const TrellisNodes n = trellis_backward(unq, dcf, acf, tc, vcost, first,
                                          rm, dm);
  unsigned levels;
  const int end = trellis_path(n, first,
                               trellis_choose(n, tc, first, ctx, rm, dm),
                               levels);
  for (int p = 0; p < 16; ++p)
    out[p] = trellis_coeff(unq[p], p ? acf : dcf, unzigzag(p), first, end,
                           levels);
  return trellis_nonzero(n, first, end, levels);
}
