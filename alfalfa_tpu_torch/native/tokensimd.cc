/* 8-lane SIMD (AVX-512) VP8 token decode for the GOP batch path.
 *
 * The range decoder is a serial dependency chain per stream; the GOP
 * batch gives 8 independent chains, which map onto the 8 64-bit lanes of
 * a zmm register.  The branchy token-tree walk of the scalar parser
 * (bitwork.cc parse_block_mask) becomes a data-driven DFA: ONE u64
 * gather per decoded bool fetches {probability, next-state-on-0,
 * next-state-on-1, action flags, value fields} for every lane at once.
 *
 * Layout of the machine:
 *  - DFA states enumerate (block_type, coeff_index, token_context, tree
 *    node) plus the fixed-prob extra-bit / sign nodes (reference
 *    bool_decoder.hh + RFC 6386 13.2-13.3; scalar twin bitwork.cc:178).
 *    ~4.2K states x 8 bytes; lanes whose frames share coeff_probs share
 *    one table (the common GOP-lockstep case).
 *  - A per-lane SCHEDULE precomputed from the MB-header outputs (skip /
 *    y2_coded maps) lists every coded block in parse order with its
 *    dense base and the nz-context PRODUCER slots (an earlier block's
 *    nz cell, or constant 0 for edges and skipped MBs).  Block
 *    transitions are two gathers + one scatter under a lane mask.
 *  - Emission is a masked scatter of (dense_pos, value) u64 records in
 *    parse (zigzag) order; a scalar phase B per lane re-walks records
 *    into the exact compact delta stream of bitwork.cc emit_block
 *    (ascending dense order, buffered Y2, 16-bit delta escapes), so the
 *    output is bit-identical to vp8_parse_tokens_gop.
 *
 * Streams with multiple DCT partitions fall back to the scalar path
 * (lanes are streams here; partition-as-lane needs cross-lane wavefront
 * ordering for the nz context).
 *
 * A copy of the JAX package's native/tokensimd.cc with two changes: the
 * engine workers share the caller's workspace (see the note at ``ws`` in
 * vp8_parse_tokens_gop_simd), and the environment-switched debug timing
 * print is gone.
 */
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <thread>
#include <vector>

#if defined(__AVX512F__) && defined(__AVX512BW__) && defined(__AVX512DQ__) \
    && defined(__AVX512CD__)
#define TOKENSIMD_OK 1
#include <immintrin.h>
#else
#define TOKENSIMD_OK 0
#endif

namespace {

constexpr uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6,
                                 9, 12, 13, 10, 7, 11, 14, 15};
constexpr uint8_t kBand[16] = {0, 1, 2, 3, 6, 4, 5, 6,
                               6, 6, 6, 6, 6, 6, 6, 7};

struct TokenExtra {
  uint16_t base;
  uint8_t nbits;
  uint8_t probs[11];
};

constexpr TokenExtra kExtra[5] = {
    {7, 2, {165, 145}},
    {11, 3, {173, 148, 140}},
    {19, 4, {176, 155, 140, 135}},
    {35, 5, {180, 157, 141, 134, 130}},
    {67, 11, {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129}},
};

/* ---- DFA state ids ----------------------------------------------------
 * id 0 = DEAD (self-loop, no actions).  Per (bt, i): 66 slots:
 *   0-2   E  (EOB node, ctx 0..2)        — consecutive so that the
 *                                          schedule start is base + ctx
 *   3-5   Z  (zero node, ctx 0..2)
 *   6-8   O  (one node)
 *   9-32  N3..N10 (8 nodes x 3 ctx)
 *   33    n159 (DCT 5/6 pick, fixed prob 159)
 *   34-58 extra-bit chains (cat0..4: 2+3+4+5+11)
 *   59    sign, value 1   (next ctx 1)
 *   60    sign, literal   (next ctx 2, vbase 0)
 *   61-65 sign, cat0..4   (next ctx 2, vbase 7/11/19/35/67)
 */
constexpr int SLOTS = 66;
constexpr int N_STATES = 1 + 4 * 16 * SLOTS;   /* 4225 */

inline int sid(int bt, int i, int slot) {
  return 1 + (bt * 16 + i) * SLOTS + slot;
}

/* entry bit layout (LSB up):
 *  0-7   prob
 *  8-20  n0   21-33 n1
 *  34-36 action: 0 none, 1 VSET (vacc = bit ? vb1 : vb0),
 *                2 ACC (vacc = 2*vacc + bit),
 *                3 EMIT (val = vbase + vacc, negated if bit)
 *  37    BLK0 (block ends if bit == 0)
 *  38    BLK1 (block ends if bit == 1)
 *  39-45 vb0 / vbase (7 bits, <= 67)
 *  46-52 vb1
 *  53-56 zoff (dense offset inside the 16-coeff block = kZigzag[i])
 */
constexpr uint64_t A_VSET = 1, A_ACC = 2, A_EMIT = 3;

inline uint64_t mk(uint32_t prob, uint32_t n0, uint32_t n1,
                   uint64_t action = 0, uint64_t blk0 = 0, uint64_t blk1 = 0,
                   uint64_t vb0 = 0, uint64_t vb1 = 0, uint64_t zoff = 0) {
  return (uint64_t)prob | ((uint64_t)n0 << 8) | ((uint64_t)n1 << 21)
         | (action << 34) | (blk0 << 37) | (blk1 << 38)
         | (vb0 << 39) | (vb1 << 46) | (zoff << 53);
}

/* Build the packed DFA for one frame's coeff_probs (4,8,3,11 u8). */
void build_dfa(const uint8_t *probs, uint64_t *t) {
  t[0] = mk(128, 0, 0);                          /* DEAD */
  for (int bt = 0; bt < 4; bt++) {
    for (int i = 0; i < 16; i++) {
      const uint64_t zoff = kZigzag[i];
      const int s_v1 = sid(bt, i, 59), s_lit = sid(bt, i, 60);
      const int last = i == 15;
      /* sign states: EMIT, then EOB node of the next index (entered with
       * last_was_zero = false) at the context the emitted value sets */
      const int e1n = last ? 0 : sid(bt, i + 1, 0 + 1);  /* E ctx1 */
      const int e2n = last ? 0 : sid(bt, i + 1, 0 + 2);  /* E ctx2 */
      t[s_v1] = mk(128, e1n, e1n, A_EMIT, last, last, 0, 0, zoff);
      t[s_lit] = mk(128, e2n, e2n, A_EMIT, last, last, 0, 0, zoff);
      for (int c = 0; c < 5; c++)
        t[sid(bt, i, 61 + c)] = mk(128, e2n, e2n, A_EMIT, last, last,
                                   kExtra[c].base, 0, zoff);
      /* extra-bit chains */
      int eb = 34;
      for (int c = 0; c < 5; c++) {
        for (int j = 0; j < kExtra[c].nbits; j++) {
          const int nxt = (j + 1 < kExtra[c].nbits)
                              ? sid(bt, i, eb + j + 1)
                              : sid(bt, i, 61 + c);
          t[sid(bt, i, eb + j)] = mk(kExtra[c].probs[j], nxt, nxt, A_ACC);
        }
        eb += kExtra[c].nbits;
      }
      /* DCT 5/6 pick */
      t[sid(bt, i, 33)] = mk(159, s_lit, s_lit, A_VSET, 0, 0, 5, 6);
      for (int ctx = 0; ctx < 3; ctx++) {
        const uint8_t *P = probs + ((bt * 8 + kBand[i]) * 3 + ctx) * 11;
        const int Z = sid(bt, i, 3 + ctx), O = sid(bt, i, 6 + ctx);
        const int N3 = sid(bt, i, 9 + ctx), N4 = sid(bt, i, 12 + ctx);
        const int N5 = sid(bt, i, 15 + ctx), N6 = sid(bt, i, 18 + ctx);
        const int N7 = sid(bt, i, 21 + ctx), N8 = sid(bt, i, 24 + ctx);
        const int N9 = sid(bt, i, 27 + ctx), N10 = sid(bt, i, 30 + ctx);
        /* E: bit0 = end of block, bit1 = token present */
        t[sid(bt, i, 0 + ctx)] = mk(P[0], 0, Z, 0, /*blk0=*/1, 0);
        /* Z: bit0 = coeff 0 -> next index, EOB check skipped, ctx 0 */
        t[Z] = mk(P[1], last ? 0 : sid(bt, i + 1, 3 + 0), O, 0,
                  /*blk0=*/last, 0);
        t[O] = mk(P[2], s_v1, N3, A_VSET, 0, 0, 1, 0);
        t[N3] = mk(P[3], N4, N6);
        t[N4] = mk(P[4], s_lit, N5, A_VSET, 0, 0, 2, 0);
        t[N5] = mk(P[5], s_lit, s_lit, A_VSET, 0, 0, 3, 4);
        t[N6] = mk(P[6], N7, N8);
        t[N7] = mk(P[7], sid(bt, i, 33), sid(bt, i, 34), A_VSET, 0, 0, 0, 0);
        t[N8] = mk(P[8], N9, N10);
        t[N9] = mk(P[9], sid(bt, i, 34 + 2), sid(bt, i, 34 + 5),
                   A_VSET, 0, 0, 0, 0);
        t[N10] = mk(P[10], sid(bt, i, 34 + 9), sid(bt, i, 34 + 14),
                    A_VSET, 0, 0, 0, 0);
      }
    }
  }
}

/* ---- per-lane block schedule ------------------------------------------
 * One entry per coded block, in parse order (Y2 first, then Y 0..15,
 * U 0..3, V 0..3 of every live MB in raster order).
 *   sched u64: start_base (13) | srcA (21) | srcB (21)
 *   dense u32: mb*400 + slot*16
 * src* are indices into the lane's nz u32 array (slot mb*25+bslot+1, so
 * 0 reads the permanently-zero cell = edge / skipped-MB / invalid ctx).
 */
struct Sched {
  std::vector<uint64_t> e;
  std::vector<uint32_t> dense;
  int64_t n = 0;          /* valid entries including the sentinel */
};

/* Only the boundary cells of a macroblock can feed a LATER block's
 * context: the bottom 4x4 row feeds the row below, the right column
 * feeds the MB to the right; interior producers are plain arithmetic on
 * the current MB's nz base.  So the builder carries one row of producer
 * cells per plane (rowbuf) plus tiny per-row left arrays instead of
 * full planes.  rowbuf: y (4C) | u (2C) | v (2C) | y2above (C) |
 * y2above_valid (C), all u32. */
void build_schedule(const uint8_t *skip, const uint8_t *y2c, int R, int C,
                    Sched &out, std::vector<uint32_t> &rowbuf) {
  rowbuf.assign((size_t)C * 10, 0);
  uint32_t *yrow = rowbuf.data();
  uint32_t *urow = yrow + 4 * C;
  uint32_t *vrow = urow + 2 * C;
  uint32_t *y2ab = vrow + 2 * C;
  uint32_t *y2av = y2ab + C;
  const size_t cap = (size_t)R * C * 25 + 1;
  if (out.e.size() < cap) {
    out.e.resize(cap);
    out.dense.resize(cap);
  }
  uint64_t *pe = out.e.data();
  uint32_t *pd = out.dense.data();
  size_t k = 0;
  for (int r = 0; r < R; r++) {
    uint32_t y2left = 0, y2lv = 0;
    uint32_t yleft[4] = {0, 0, 0, 0}, uleft[2] = {0, 0}, vleft[2] = {0, 0};
    for (int c = 0; c < C; c++) {
      const int mb = r * C + c;
      const uint32_t nzi0 = (uint32_t)mb * 25 + 1;
      if (skip[mb]) {
        for (int i = 0; i < 4; i++) {
          yrow[c * 4 + i] = 0;
          yleft[i] = 0;
        }
        urow[c * 2] = urow[c * 2 + 1] = vrow[c * 2] = vrow[c * 2 + 1] = 0;
        uleft[0] = uleft[1] = vleft[0] = vleft[1] = 0;
        if (y2c[mb]) {
          y2ab[c] = 0;
          y2av[c] = 1;
          y2left = 0;
          y2lv = 1;
        }
        continue;
      }
      const int has_y2 = y2c[mb] != 0;
      if (has_y2) {
        const uint64_t sa = y2av[c] ? y2ab[c] : 0;
        const uint64_t sb = y2lv ? y2left : 0;
        pe[k] = (uint64_t)sid(1, 0, 0) | (sa << 13) | (sb << 34);
        pd[k++] = (uint32_t)mb * 400 + 384;
        y2ab[c] = nzi0 + 24;
        y2av[c] = 1;
        y2left = nzi0 + 24;
        y2lv = 1;
      }
      const uint64_t ystart =
          (uint64_t)sid(has_y2 ? 0 : 3, has_y2 ? 1 : 0, 0);
      for (int b = 0; b < 16; b++) {
        const int sr = b >> 2, sc = b & 3;
        const uint64_t sa = sr ? nzi0 + b - 4 : yrow[c * 4 + sc];
        const uint64_t sb = sc ? nzi0 + b - 1 : yleft[sr];
        pe[k] = ystart | (sa << 13) | (sb << 34);
        pd[k++] = (uint32_t)mb * 400 + b * 16;
      }
      for (int i = 0; i < 4; i++) {
        yrow[c * 4 + i] = nzi0 + 12 + i;   /* bottom 4x4 row (b 12..15) */
        yleft[i] = nzi0 + 4 * i + 3;       /* right column (b 3,7,11,15) */
      }
      const uint64_t cstart = (uint64_t)sid(2, 0, 0);
      for (int pl = 0; pl < 2; pl++) {
        uint32_t *prow = pl ? vrow : urow;
        uint32_t *pleft = pl ? vleft : uleft;
        const uint32_t base = nzi0 + 16 + pl * 4;
        for (int b = 0; b < 4; b++) {
          const int sr = b >> 1, sc = b & 1;
          const uint64_t sa = sr ? base + b - 2 : prow[c * 2 + sc];
          const uint64_t sb = sc ? base + b - 1 : pleft[sr];
          pe[k] = cstart | (sa << 13) | (sb << 34);
          pd[k++] = (uint32_t)mb * 400 + (16 + pl * 4 + b) * 16;
        }
        prow[c * 2] = base + 2;
        prow[c * 2 + 1] = base + 3;
        pleft[0] = base + 1;
        pleft[1] = base + 3;
      }
    }
  }
  /* sentinel: entering it puts the lane in DEAD */
  pe[k] = 0;
  pd[k++] = 0;
  out.n = (int64_t)k;
}

#if TOKENSIMD_OK

static thread_local int64_t g_engine_iters = 0;

/* ---- the engine -------------------------------------------------------
 * Decodes up to 8 lanes until every lane's schedule is exhausted.
 * Returns false on record-buffer overflow (any lane). */
struct Lane {
  const uint8_t *data;    /* padded arena pointer (>= 16 zero bytes tail) */
  int64_t size;           /* logical stream size */
  const uint64_t *dfa;
  const uint64_t *sched;
  const uint32_t *dense;
  int64_t n_sched;        /* excluding sentinel */
  uint32_t *nz;           /* (R*C*25 + 1) u32, zero-initialized */
  uint64_t *rec;          /* record sink */
  int64_t rec_cap;
  int64_t rec_count;      /* out */
};

/* One engine's full architectural state, steppable one iteration at a
 * time so TWO independent engines can interleave in one loop: the
 * per-iteration critical path (state gather -> mullo split -> compare ->
 * next-state select) is ~75 cycles of latency against ~20 uops of work,
 * so a second chain nearly doubles per-core throughput at 16 streams. */
struct EngState {
  Lane *L;
  int n_lanes;
  int64_t rec0_[8];
  __m512i dbase, dfab, schb, schd, nzb, rcur, rlim, nsch, szp;
  __m512i value, range, count, pos, state, vacc, bbase, blknz, cursor;
  __mmask8 overflow, f_blk;
  int64_t it;
  bool done, failed;

  inline void refill_m(__mmask8 m);
  void init(Lane *L_, int n_lanes_);
  inline void step();
  bool finish();
};

void EngState::init(Lane *L_, int n_lanes_) {
  L = L_;
  n_lanes = n_lanes_;
  /* dead filler lanes (n_lanes < 8) read this empty schedule: entry 0 is
   * the sentinel, so their prologue block-advance lands in DEAD */
  static const uint64_t kEmptySched[1] = {0};
  static const uint32_t kEmptyDense[1] = {0};
  /* per-lane constant bases */
  int64_t dbase_[8] = {}, dfab_[8] = {}, schb_[8] = {}, schd_[8] = {},
          nzb_[8] = {}, rlim_[8] = {}, nsch_[8] = {}, szp_[8] = {};
  for (int l = 0; l < 8; l++) {
    const Lane &a = L[l < n_lanes ? l : 0];
    dbase_[l] = (int64_t)a.data;
    dfab_[l] = (int64_t)a.dfa;
    schb_[l] = l < n_lanes ? (int64_t)a.sched : (int64_t)kEmptySched;
    schd_[l] = l < n_lanes ? (int64_t)a.dense : (int64_t)kEmptyDense;
    nzb_[l] = (int64_t)a.nz;
    rec0_[l] = (int64_t)a.rec;
    rlim_[l] = (int64_t)(a.rec + a.rec_cap);
    nsch_[l] = l < n_lanes ? a.n_sched : 0;
    szp_[l] = a.size + 8;
  }
  dbase = _mm512_loadu_si512(dbase_);
  dfab = _mm512_loadu_si512(dfab_);
  schb = _mm512_loadu_si512(schb_);
  schd = _mm512_loadu_si512(schd_);
  nzb = _mm512_loadu_si512(nzb_);
  rcur = _mm512_loadu_si512(rec0_);
  rlim = _mm512_loadu_si512(rlim_);
  nsch = _mm512_loadu_si512(nsch_);
  szp = _mm512_loadu_si512(szp_);

  const __m512i k0 = _mm512_setzero_si512();
  value = k0;
  range = _mm512_set1_epi64(255);
  count = _mm512_set1_epi64(-8);
  pos = k0;
  state = k0;
  vacc = k0;
  bbase = _mm512_set1_epi64(-16);
  blknz = k0;
  cursor = k0;
  overflow = 0;
  f_blk = 0xFF;   /* prologue: every lane performs its first block-advance */
  it = 0;
  done = failed = false;
  refill_m(0xFF);
}

inline void EngState::refill_m(__mmask8 m) {
  const __m512i k1 = _mm512_set1_epi64(1);
  const __m512i k0 = _mm512_setzero_si512();
  {
    __m512i p = _mm512_min_epi64(pos, szp);
    __m512i big = _mm512_mask_i64gather_epi64(
        k0, m, _mm512_add_epi64(dbase, p), (const long long *)0, 1);
    const __m512i bswap_idx = _mm512_set_epi8(
        56, 57, 58, 59, 60, 61, 62, 63, 48, 49, 50, 51, 52, 53, 54, 55,
        40, 41, 42, 43, 44, 45, 46, 47, 32, 33, 34, 35, 36, 37, 38, 39,
        24, 25, 26, 27, 28, 29, 30, 31, 16, 17, 18, 19, 20, 21, 22, 23,
        8, 9, 10, 11, 12, 13, 14, 15, 0, 1, 2, 3, 4, 5, 6, 7);
    big = _mm512_shuffle_epi8(big, bswap_idx);
    /* FastBool::fill() zero-past-EOS semantics come from the arena: every
     * stream is followed by >= 16 zero bytes, and p is clamped to size+8 */
    __m512i shift = _mm512_sub_epi64(_mm512_set1_epi64(48), count);
    __m512i nbytes = _mm512_add_epi64(_mm512_srli_epi64(shift, 3), k1);
    __m512i sh1 = _mm512_sub_epi64(_mm512_set1_epi64(56), shift);
    __m512i piece = _mm512_srlv_epi64(big, sh1);
    __m512i maskv = _mm512_sllv_epi64(_mm512_set1_epi64(-1),
                                      _mm512_and_epi64(shift,
                                                       _mm512_set1_epi64(7)));
    piece = _mm512_and_epi64(piece, maskv);
    value = _mm512_mask_or_epi64(value, m, value, piece);
    pos = _mm512_mask_add_epi64(pos, m, pos, nbytes);
    count = _mm512_mask_add_epi64(count, m, count,
                                  _mm512_slli_epi64(nbytes, 3));
  }
}

/* one iteration: pending block-advance, then one bool for all lanes */
inline void EngState::step() {
  const __m512i k1 = _mm512_set1_epi64(1);
  const __m512i k0 = _mm512_setzero_si512();
  const int64_t max_iter = (int64_t)64 << 20;
  {
    if (f_blk) {
      /* finished-block nz store: nz[(bbase>>4)+1] = blknz (epi32) */
      __m512i nzslot = _mm512_add_epi64(_mm512_srai_epi64(bbase, 4), k1);
      _mm512_mask_i64scatter_epi32(
          (void *)0, f_blk,
          _mm512_add_epi64(nzb, _mm512_slli_epi64(nzslot, 2)),
          _mm512_cvtepi64_epi32(blknz), 1);
      blknz = _mm512_maskz_mov_epi64(~f_blk, blknz);
      __m512i cur = _mm512_min_epi64(cursor, nsch);
      __m512i se = _mm512_mask_i64gather_epi64(
          k0, f_blk, _mm512_add_epi64(schb, _mm512_slli_epi64(cur, 3)),
          (const long long *)0, 1);
      __m512i dn = _mm512_mask_i64gather_epi64(
          k0, f_blk, _mm512_add_epi64(schd, _mm512_slli_epi64(cur, 2)),
          (const long long *)0, 1);
      dn = _mm512_and_epi64(dn, _mm512_set1_epi64(0xFFFFFFFF));
      cursor = _mm512_mask_add_epi64(cursor, f_blk, cur, k1);
      __m512i srcA = _mm512_and_epi64(_mm512_srli_epi64(se, 13),
                                      _mm512_set1_epi64(0x1FFFFF));
      __m512i srcB = _mm512_and_epi64(_mm512_srli_epi64(se, 34),
                                      _mm512_set1_epi64(0x1FFFFF));
      __m512i nzA = _mm512_mask_i64gather_epi64(
          k0, f_blk, _mm512_add_epi64(nzb, _mm512_slli_epi64(srcA, 2)),
          (const long long *)0, 1);
      __m512i nzB = _mm512_mask_i64gather_epi64(
          k0, f_blk, _mm512_add_epi64(nzb, _mm512_slli_epi64(srcB, 2)),
          (const long long *)0, 1);
      __m512i ctx = _mm512_add_epi64(_mm512_and_epi64(nzA, k1),
                                     _mm512_and_epi64(nzB, k1));
      __m512i start = _mm512_add_epi64(
          _mm512_and_epi64(se, _mm512_set1_epi64(0x1FFF)), ctx);
      /* sentinel entries have start_base 0 (DEAD): keep ctx out of them */
      __mmask8 sent = _mm512_mask_cmpeq_epi64_mask(
          f_blk, _mm512_and_epi64(se, _mm512_set1_epi64(0x1FFF)), k0);
      start = _mm512_maskz_mov_epi64(~sent, start);
      state = _mm512_mask_mov_epi64(state, f_blk, start);
      bbase = _mm512_mask_mov_epi64(bbase, f_blk, dn);
      /* all lanes dead? */
      if (_mm512_cmpeq_epi64_mask(state, k0) == 0xFF) {
        done = true;
        return;
      }
    }
    if (it >= max_iter) {
      failed = true;
      done = true;
      return;
    }

    /* ---- one bool for all lanes ---- */
    __m512i ev = _mm512_i64gather_epi64(
        _mm512_add_epi64(dfab, _mm512_slli_epi64(state, 3)),
        (const void *)0, 1);
    __m512i probv = _mm512_and_epi64(ev, _mm512_set1_epi64(0xFF));
    __m512i split = _mm512_add_epi64(
        _mm512_srli_epi64(
            _mm512_mullo_epi64(_mm512_sub_epi64(range, k1), probv), 8),
        k1);
    __m512i big_split = _mm512_slli_epi64(split, 56);
    __mmask8 bit = _mm512_cmpge_epu64_mask(value, big_split);
    range = _mm512_mask_sub_epi64(split, bit, range, split);
    value = _mm512_mask_sub_epi64(value, bit, value, big_split);
    __m512i sh = _mm512_sub_epi64(_mm512_lzcnt_epi64(range),
                                  _mm512_set1_epi64(56));
    value = _mm512_sllv_epi64(value, sh);
    range = _mm512_sllv_epi64(range, sh);
    count = _mm512_sub_epi64(count, sh);
    __mmask8 need = _mm512_cmplt_epi64_mask(count, k0);
    if (need) refill_m(need);

    __m512i action = _mm512_and_epi64(_mm512_srli_epi64(ev, 34),
                                      _mm512_set1_epi64(7));
    __mmask8 f_vset = _mm512_cmpeq_epi64_mask(action, k1);
    __mmask8 f_acc = _mm512_cmpeq_epi64_mask(action, _mm512_set1_epi64(2));
    __mmask8 f_emit = _mm512_cmpeq_epi64_mask(action, _mm512_set1_epi64(3));
    __m512i bitv = _mm512_maskz_set1_epi64(bit, 1);
    __m512i vb0 = _mm512_and_epi64(_mm512_srli_epi64(ev, 39),
                                   _mm512_set1_epi64(0x7F));
    __m512i vb1 = _mm512_and_epi64(_mm512_srli_epi64(ev, 46),
                                   _mm512_set1_epi64(0x7F));
    vacc = _mm512_mask_mov_epi64(vacc, f_vset & ~bit, vb0);
    vacc = _mm512_mask_mov_epi64(vacc, f_vset & bit, vb1);
    vacc = _mm512_mask_add_epi64(vacc, f_acc, _mm512_slli_epi64(vacc, 1),
                                 bitv);
    if (f_emit) {
      __m512i zoff = _mm512_and_epi64(_mm512_srli_epi64(ev, 53),
                                      _mm512_set1_epi64(0xF));
      __m512i val = _mm512_add_epi64(vb0, vacc);        /* vbase + vacc */
      /* negate where sign bit set */
      val = _mm512_mask_sub_epi64(val, bit, k0, val);
      __m512i dpos = _mm512_add_epi64(bbase, zoff);
      __m512i rec = _mm512_or_epi64(
          _mm512_slli_epi64(dpos, 16),
          _mm512_and_epi64(val, _mm512_set1_epi64(0xFFFF)));
      overflow |= _mm512_mask_cmpge_epu64_mask(f_emit, rcur, rlim);
      __m512i at = _mm512_min_epu64(rcur, _mm512_sub_epi64(rlim,
                                    _mm512_set1_epi64(8)));
      _mm512_mask_i64scatter_epi64((void *)0, f_emit, at, rec, 1);
      rcur = _mm512_mask_add_epi64(rcur, f_emit, at, _mm512_set1_epi64(8));
      blknz = _mm512_mask_mov_epi64(blknz, f_emit, k1);
    }
    /* next state + block-end flags */
    __m512i n0 = _mm512_and_epi64(_mm512_srli_epi64(ev, 8),
                                  _mm512_set1_epi64(0x1FFF));
    __m512i n1 = _mm512_and_epi64(_mm512_srli_epi64(ev, 21),
                                  _mm512_set1_epi64(0x1FFF));
    state = _mm512_mask_mov_epi64(n0, bit, n1);
    __mmask8 blk0 = _mm512_test_epi64_mask(ev, _mm512_set1_epi64(1ULL << 37));
    __mmask8 blk1 = _mm512_test_epi64_mask(ev, _mm512_set1_epi64(1ULL << 38));
    f_blk = (blk0 & ~bit) | (blk1 & bit);
  }
  it++;
}

bool EngState::finish() {
  alignas(64) int64_t tmp[8];
  if (failed || overflow) return false;
  _mm512_storeu_si512(tmp, rcur);
  for (int l = 0; l < n_lanes; l++)
    L[l].rec_count = (tmp[l] - rec0_[l]) >> 3;
  g_engine_iters += it;
  return true;
}

bool run_engine(Lane *L, int n_lanes) {
  EngState s;
  s.init(L, n_lanes);
  while (!s.done) s.step();
  return s.finish();
}

/* Two engines advanced alternately in one loop: the decode sequences are
 * untouched (bit-exact per engine), the chains just overlap in the
 * out-of-order core.  Returns bit0/bit1 = engine A/B ok. */
int run_engine_pair(Lane *A, int na, Lane *B, int nb) {
  EngState a, b;
  a.init(A, na);
  b.init(B, nb);
  while (!(a.done & b.done)) {
    if (!a.done) a.step();
    if (!b.done) b.step();
  }
  return (a.finish() ? 1 : 0) | (b.finish() ? 2 : 0);
}

#endif  /* TOKENSIMD_OK */

/* ---- phase B: records -> exact compact stream -------------------------
 * Reproduces bitwork.cc emit_block byte-for-byte: ascending dense order
 * within each MB (Y2 parsed first but emitted last), strictly-positive
 * u8 deltas with escape lists, per-segment counts in seg_meta. */
struct EmitCtx {
  uint8_t *sp_delta;
  int8_t *sp_val;
  int32_t *desc_pos;
  int32_t *desc_extra;
  int32_t *vesc_pos;
  int16_t *vesc_val;
  int64_t p, lim, epos_d, epos_v, esc_lim, last;
  bool overflow;
};

inline void emit_one(EmitCtx &E, int64_t idx, int v) {
  if (E.p >= E.lim) { E.overflow = true; return; }
  int64_t d = idx - E.last;
  if (d > 255) {
    if (E.epos_d >= E.esc_lim) { E.overflow = true; return; }
    E.desc_pos[E.epos_d] = (int32_t)E.p;
    E.desc_extra[E.epos_d] = (int32_t)(d - 255);
    E.epos_d++;
    d = 255;
  }
  if (v < -128 || v > 127) {
    if (E.epos_v >= E.esc_lim) { E.overflow = true; return; }
    E.vesc_pos[E.epos_v] = (int32_t)E.p;
    E.vesc_val[E.epos_v] = (int16_t)v;
    E.epos_v++;
    v = 0;
  }
  E.sp_delta[E.p] = (uint8_t)d;
  E.sp_val[E.p] = (int8_t)v;
  E.last = idx;
  E.p++;
}

/* Emit one block's collected coefficients in ascending dense order
 * (records arrive in token/zigzag order; the compact stream walks the
 * set-bit mask ascending, exactly like bitwork.cc emit_block). */
inline void emit_block_sorted(EmitCtx &E, int64_t base, const int16_t *tmp,
                              uint32_t mask) {
  while (mask) {
    const int b = __builtin_ctz(mask);
    mask &= mask - 1;
    emit_one(E, base + b, tmp[b]);
  }
}

/* Walk one lane's records (parse order).  g_off: dense offset of the
 * lane's frame in the batch layout.  Fills has_nonzero (R*C u8). */
bool phase_b(const uint64_t *rec, int64_t n, int64_t g_off,
             uint8_t *has_nonzero, EmitCtx &E) {
  int64_t i = 0;
  int16_t tmp[16], y2tmp[16];
  while (i < n) {
    const uint32_t mb = (uint32_t)(rec[i] >> 16) / 400;
    /* Y2 records (slot 24) lead the MB's records but sort last */
    uint32_t y2mask = 0;
    while (i < n && (uint32_t)(rec[i] >> 16) / 400 == mb
           && ((uint32_t)(rec[i] >> 16) % 400) >= 384) {
      const int b = (uint32_t)(rec[i] >> 16) & 15;
      y2tmp[b] = (int16_t)(uint16_t)rec[i];
      y2mask |= 1u << b;
      i++;
    }
    bool any = y2mask != 0;
    /* Y/U/V blocks arrive in ascending block order; coefficients inside
     * each block arrive zigzag — regroup per block and emit sorted */
    while (i < n && (uint32_t)(rec[i] >> 16) / 400 == mb
           && ((uint32_t)(rec[i] >> 16) % 400) < 384) {
      const uint32_t blk = (uint32_t)(rec[i] >> 16) >> 4;
      uint32_t mask = 0;
      while (i < n && ((uint32_t)(rec[i] >> 16) >> 4) == blk) {
        const int b = (uint32_t)(rec[i] >> 16) & 15;
        tmp[b] = (int16_t)(uint16_t)rec[i];
        mask |= 1u << b;
        i++;
      }
      emit_block_sorted(E, g_off + (int64_t)blk * 16, tmp, mask);
      any = true;
    }
    if (y2mask)
      emit_block_sorted(E, g_off + (int64_t)mb * 400 + 384, y2tmp, y2mask);
    has_nonzero[mb] = any ? 1 : has_nonzero[mb];
    if (E.overflow) return false;
  }
  return true;
}

}  // namespace

extern "C" {

/* debug/test: expose the packed DFA (out must hold 4225 u64) */
int vp8_build_token_dfa_export(const uint8_t *probs, uint64_t *out) {
  build_dfa(probs, out);
  return N_STATES;
}

/* debug/test: start-state id of (bt, first) at ctx 0 */
int vp8_token_dfa_start(int bt, int first) { return sid(bt, first, 0); }

int vp8_token_simd_supported(void) {
#if TOKENSIMD_OK
  return 1;
#else
  return 0;
#endif
}

/* SIMD twin of vp8_parse_tokens_gop for single-partition streams.
 * data/off: concatenated first... DCT partitions (off has G+1 entries);
 * outputs and seg_meta exactly as bitwork.cc (bit-identical stream).
 * threads: engines (ceil(G/8)) fan over std::threads when > 1.
 * Returns 0 ok, -2 capacity overflow (retry bigger), -1 unsupported. */
int vp8_parse_tokens_gop_simd(
    int threads, int G, int mb_rows, int mb_cols,
    const uint8_t *data, const int64_t *off,
    const uint8_t *coeff_probs /* (G,4,8,3,11) */,
    const uint8_t *skip, const uint8_t *y2_coded, uint8_t *has_nonzero_out,
    uint8_t *sp_delta, int8_t *sp_val,
    int32_t *desc_pos, int32_t *desc_extra,
    int32_t *vesc_pos, int16_t *vesc_val,
    int64_t *seg_meta) {
#if !TOKENSIMD_OK
  (void)threads; (void)G; (void)mb_rows; (void)mb_cols; (void)data;
  (void)off; (void)coeff_probs; (void)skip; (void)y2_coded;
  (void)has_nonzero_out; (void)sp_delta; (void)sp_val; (void)desc_pos;
  (void)desc_extra; (void)vesc_pos; (void)vesc_val; (void)seg_meta;
  return -1;
#else
  if (G < 1 || G > 32) return -1;
  const int R = mb_rows, C = mb_cols;
  const int64_t n_mb = (int64_t)R * C;

  /* reusable per-thread workspace: every buffer here keeps its capacity
   * across calls, so a steady-state frame costs zero allocation and no
   * redundant zero-fill (nz slots are written before any read within a
   * frame; slot 0 is reserved and only ever written 0) */
  struct Workspace {
    std::vector<uint64_t> tables[32];
    std::vector<uint8_t> arena;
    Sched sched[32];
    std::vector<uint32_t> nz[32];
    std::vector<uint64_t> recs[32];
    std::vector<uint32_t> rowbuf[4];    /* one scratch per engine thread */
  };
  /* The workspace is per calling thread, but the engine workers below
   * must all share the CALLER's: a thread_local named inside a lambda is
   * not captured by [&], so each std::thread would resolve ``ws`` to its
   * own empty Workspace and write through a null arena (the G > 8,
   * threads > 1 fault of the copy this file was taken from).  Binding a
   * reference makes [&] capture the caller's workspace.  Sharing it is
   * race-free: every worker touches only its own lanes' slots and its
   * own rowbuf, and the arena is sized before the threads start. */
  static thread_local Workspace ws_tl;
  Workspace &ws = ws_tl;

  /* DFA tables, shared between lanes with identical prob bytes */
  const uint64_t *lane_dfa[32];
  int table_of[32];
  int n_tables = 0;
  for (int g = 0; g < G; g++) {
    const uint8_t *pg = coeff_probs + (size_t)g * 1056;
    table_of[g] = -1;
    for (int h = 0; h < g; h++)
      if (memcmp(pg, coeff_probs + (size_t)h * 1056, 1056) == 0) {
        table_of[g] = table_of[h];
        break;
      }
    if (table_of[g] < 0) {
      ws.tables[n_tables].resize(N_STATES);
      build_dfa(pg, ws.tables[n_tables].data());
      table_of[g] = n_tables++;
    }
  }
  for (int g = 0; g < G; g++) lane_dfa[g] = ws.tables[table_of[g]].data();

  /* padded stream arena: FastBool reads zeros past EOS.  The resize is
   * one shot here; the per-lane copies happen inside the workers. */
  const int64_t total = off[G];
  const size_t need = (size_t)(total + (int64_t)16 * G + 16);
  if (ws.arena.size() < need) ws.arena.resize(need);
  int64_t abase[32];
  {
    int64_t w = 0;
    for (int g = 0; g < G; g++) {
      abase[g] = w;
      w += off[g + 1] - off[g] + 16;
    }
  }

  const int64_t *seg_base = seg_meta;
  int64_t *seg_count = seg_meta + G + 1;
  const int64_t *esc_base = seg_meta + 2 * G + 1;
  int64_t *desc_count = seg_meta + 3 * G + 2;
  int64_t *vesc_count = seg_meta + 4 * G + 2;
  int64_t *last_out = seg_meta + 5 * G + 2;

  /* every per-lane stage (arena copy, schedule build, engine, record ->
   * stream emission) runs inside that lane's engine worker, so with two
   * engines on two cores the whole token phase parallelizes, not just
   * the bool loop */
  const int n_eng = (G + 7) / 8;
  Lane lanes[32];
  g_engine_iters = 0;
  char eng_ok[4] = {1, 1, 1, 1};
  char pb_overflow[32] = {};
  const int64_t felems = n_mb * 400;

  auto prep_one = [&](int g, std::vector<uint32_t> &rowbuf) {
    const int64_t bytes = off[g + 1] - off[g];
    memcpy(ws.arena.data() + abase[g], data + off[g], bytes);
    memset(ws.arena.data() + abase[g] + bytes, 0, 16);
    build_schedule(skip + g * n_mb, y2_coded + g * n_mb, R, C, ws.sched[g],
                   rowbuf);
    if (ws.nz[g].size() < (size_t)(n_mb * 25 + 2))
      ws.nz[g].resize(n_mb * 25 + 2);     /* zero-filled on first growth */
    const size_t cap = (size_t)std::min<int64_t>(n_mb * 400,
                                                 4 * bytes + 4096);
    if (ws.recs[g].size() < cap) ws.recs[g].resize(cap);
    Lane &l = lanes[g];
    l.data = ws.arena.data() + abase[g];
    l.size = bytes;
    l.dfa = lane_dfa[g];
    l.sched = ws.sched[g].e.data();
    l.dense = ws.sched[g].dense.data();
    l.n_sched = ws.sched[g].n - 1;
    l.nz = ws.nz[g].data();
    l.rec = ws.recs[g].data();
    l.rec_cap = (int64_t)ws.recs[g].size();
    l.rec_count = 0;
  };
  auto phase_b_one = [&](int g) {
    EmitCtx E;
    E.sp_delta = sp_delta;
    E.sp_val = sp_val;
    E.desc_pos = desc_pos;
    E.desc_extra = desc_extra;
    E.vesc_pos = vesc_pos;
    E.vesc_val = vesc_val;
    E.p = seg_base[g];
    E.lim = seg_base[g + 1];
    E.epos_d = E.epos_v = esc_base[g];
    E.esc_lim = esc_base[g + 1];
    E.last = (int64_t)g * felems - 1;
    E.overflow = false;
    phase_b(ws.recs[g].data(), lanes[g].rec_count, (int64_t)g * felems,
            has_nonzero_out + g * n_mb, E);
    pb_overflow[g] = E.overflow ? 1 : 0;
    seg_count[g] = E.p - seg_base[g];
    desc_count[g] = E.epos_d - esc_base[g];
    vesc_count[g] = E.epos_v - esc_base[g];
    last_out[g] = E.last;
  };
  auto regrow = [&](int e) {
    /* record-buffer overflow: retry once with the dense bound */
    const int lo = e * 8, hi = std::min(G, lo + 8);
    for (int g = lo; g < hi; g++) {
      if (ws.recs[g].size() < (size_t)(n_mb * 400))
        ws.recs[g].resize((size_t)(n_mb * 400));
      lanes[g].rec = ws.recs[g].data();
      lanes[g].rec_cap = (int64_t)ws.recs[g].size();
      lanes[g].rec_count = 0;
    }
  };
  auto work_one = [&](int e, std::vector<uint32_t> &rowbuf) {
    const int lo = e * 8, hi = std::min(G, lo + 8);
    for (int g = lo; g < hi; g++) prep_one(g, rowbuf);
    if (!run_engine(&lanes[lo], hi - lo)) {
      regrow(e);
      eng_ok[e] = run_engine(&lanes[lo], hi - lo) ? 1 : 0;
    }
    if (eng_ok[e])
      for (int g = lo; g < hi; g++) phase_b_one(g);
  };
  if (threads > 1 && n_eng > 1) {
    std::vector<std::thread> ts;
    for (int e = 0; e < n_eng; e++)
      ts.emplace_back(work_one, e, std::ref(ws.rowbuf[e]));
    for (auto &t : ts) t.join();
  } else if (n_eng > 1) {
    /* one core, several engines: interleave two dependency chains per
     * loop — per-iteration latency (~75 cy) dominates the uop count, so
     * paired chains overlap for ~2x throughput */
    for (int g = 0; g < G; g++) prep_one(g, ws.rowbuf[0]);
    for (int e = 0; e < n_eng; e += 2) {
      const int loA = e * 8, nA = std::min(G, loA + 8) - loA;
      if (e + 1 < n_eng) {
        const int loB = (e + 1) * 8, nB = std::min(G, loB + 8) - loB;
        int ok = run_engine_pair(&lanes[loA], nA, &lanes[loB], nB);
        if (!(ok & 1)) {
          regrow(e);
          eng_ok[e] = run_engine(&lanes[loA], nA) ? 1 : 0;
        }
        if (!(ok & 2)) {
          regrow(e + 1);
          eng_ok[e + 1] = run_engine(&lanes[loB], nB) ? 1 : 0;
        }
      } else if (!run_engine(&lanes[loA], nA)) {
        regrow(e);
        eng_ok[e] = run_engine(&lanes[loA], nA) ? 1 : 0;
      }
    }
    bool all_ok = true;
    for (int e = 0; e < n_eng; e++) all_ok &= eng_ok[e] != 0;
    if (all_ok)
      for (int g = 0; g < G; g++) phase_b_one(g);
  } else {
    for (int e = 0; e < n_eng; e++) work_one(e, ws.rowbuf[0]);
  }
  for (int e = 0; e < n_eng; e++)
    if (!eng_ok[e]) return -1;
  bool overflow = false;
  for (int g = 0; g < G; g++) overflow |= pb_overflow[g] != 0;
  return overflow ? -2 : 0;
#endif
}

}  // extern "C"
