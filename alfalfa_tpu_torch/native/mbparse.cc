/* Native macroblock-header parse: prediction modes, references, motion
 * vectors (census + clamp + SPLITMV), segment ids, skip flags.
 *
 * Continues from the Python-side BoolDecoder state after the frame header
 * (the header itself is cheap and stays in Python).  Semantics mirror
 * reference decoder/macroblock.cc:43-476 and scorer.hh.
 */
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct BoolDecoder {
  const uint8_t *data;
  int64_t pos, size;
  uint32_t range_, value;
  int bit_count;

  inline void load_octet() {
    if (pos < size) value |= data[pos++];
  }

  inline int get(int probability) {
    const uint32_t split = 1 + (((range_ - 1) * (uint32_t)probability) >> 8);
    const uint32_t big_split = split << 8;
    int ret;
    if (value >= big_split) {
      ret = 1;
      range_ -= split;
      value -= big_split;
    } else {
      ret = 0;
      range_ = split;
    }
    while (range_ < 128) {
      value <<= 1;
      range_ <<= 1;
      if (++bit_count == 8) {
        bit_count = 0;
        load_octet();
      }
    }
    return ret;
  }

  inline int tree(const int16_t *nodes, const uint8_t *probs) {
    int i = 0;
    while ((i = nodes[i + get(probs[i >> 1])]) > 0) {
    }
    return -i;
  }
};

/* spec constant trees (RFC 6386; see alfalfa_tpu_torch/bitstream/vp8_tables.json) */
constexpr int16_t kKfYModeTree[8] = {-4, 2, 4, 6, 0, -1, -2, -3};
constexpr int16_t kYModeTree[8] = {0, 2, 4, 6, -1, -2, -3, -4};
constexpr int16_t kUvModeTree[6] = {-0, 2, -1, 4, -2, -3};
constexpr int16_t kBModeTree[18] = {0, 2, -1, 4, -2, 6, 8, 12, -3,
                                    10, -5, -6, -4, 14, -7, 16, -8, -9};
constexpr int16_t kSmallMvTree[14] = {2, 8, 4, 6, 0, -1, -2, -3, 10, 12, -4, -5, -6, -7};
constexpr int16_t kMvRefTree[8] = {-7, 2, -5, 4, -6, 6, -8, -9};
constexpr int16_t kSubmvRefTree[6] = {-10, 2, -11, 4, -12, -13};
constexpr int16_t kSplitMvTree[6] = {-3, 2, -2, 4, -0, -1};
constexpr int16_t kSegmentIdTree[6] = {2, 4, -0, -1, -2, -3};

constexpr uint8_t kKfYModeProbs[4] = {145, 156, 163, 128};
constexpr uint8_t kKfUvModeProbs[3] = {142, 114, 183};
constexpr uint8_t kInvariantBModeProbs[9] = {120, 90, 79, 133, 87, 85, 80, 111, 151};
constexpr uint8_t kMvCountsToProbs[6][4] = {
    {7, 1, 1, 143}, {14, 18, 14, 107}, {135, 64, 57, 68},
    {60, 56, 128, 65}, {159, 134, 128, 34}, {234, 188, 128, 28}};
constexpr uint8_t kSplitMvProbs[3] = {110, 111, 150};
constexpr uint8_t kSubmvRefProbs2[5][3] = {
    {147, 136, 18}, {106, 145, 1}, {179, 121, 1}, {223, 1, 34}, {208, 1, 1}};

/* SPLITMV partition layouts: per scheme, per subblock (raster index 0..15)
 * -> partition id; and the first subblock of each partition. */
struct MvPartition {
  int num_partitions;
  uint8_t part_of[16]; /* subblock raster idx -> partition */
};

constexpr MvPartition kMvPartitions[4] = {
    /* 0: two 16x8 */ {2, {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1}},
    /* 1: two 8x16 */ {2, {0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1}},
    /* 2: four 8x8 */ {4, {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3}},
    /* 3: sixteen  */ {16, {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15}},
};

enum { DC_PRED, V_PRED, H_PRED, TM_PRED, B_PRED, NEARESTMV, NEARMV, ZEROMV,
       NEWMV, SPLITMV };
enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED };
enum { LEFT4X4 = 10, ABOVE4X4, ZERO4X4, NEW4X4 };
enum { CUR_FRAME = 0, LAST_FRAME, GOLDEN_FRAME, ALTREF_FRAME };

constexpr int8_t kImpliedBMode[4] = {B_DC_PRED, B_VE_PRED, B_HE_PRED, B_TM_PRED};

inline int16_t read_mv_component(BoolDecoder &bd, const uint8_t *probs) {
  /* macroblock.cc:197-229 */
  int x = 0;
  if (bd.get(probs[0])) { /* long */
    for (int i = 0; i < 3; i++) x += bd.get(probs[9 + i]) << i;
    for (int i = 9; i > 3; i--) x += bd.get(probs[9 + i]) << i;
    if (!(x & 0xFFF0) || bd.get(probs[9 + 3])) x += 8;
  } else {
    x = bd.tree(kSmallMvTree, probs + 2);
  }
  x <<= 1;
  if (x && bd.get(probs[1])) x = -x;
  return (int16_t)x;
}

struct MV {
  int16_t x, y;
  bool operator==(const MV &o) const { return x == o.x && y == o.y; }
  bool zero() const { return x == 0 && y == 0; }
};

inline MV read_mv(BoolDecoder &bd, const uint8_t *mv_probs) {
  MV mv;
  mv.y = read_mv_component(bd, mv_probs);       /* y first */
  mv.x = read_mv_component(bd, mv_probs + 19);
  return mv;
}

inline MV clamp_mv(MV mv, int c, int r, int C, int R) {
  const int to_left = -((c * 16) << 3) - 128;
  const int to_right = (((C - 1 - c) * 16) << 3) + 128;
  const int to_top = -((r * 16) << 3) - 128;
  const int to_bottom = (((R - 1 - r) * 16) << 3) + 128;
  int x = mv.x < to_left ? to_left : (mv.x > to_right ? to_right : mv.x);
  int y = mv.y < to_top ? to_top : (mv.y > to_bottom ? to_bottom : mv.y);
  return MV{(int16_t)x, (int16_t)y};
}

/* All state for one frame's MB-header parse, so the per-MB step can be
 * driven either frame-at-a-time (vp8_parse_mb_headers) or interleaved
 * across a GOP batch (vp8_parse_mb_headers_gop). */
struct FrameHdrCtx {
  BoolDecoder bd;
  int R, C, key_frame;
  int read_segment_id;
  const uint8_t *seg_tree_probs;
  int has_skip_prob;
  uint8_t prob_skip, prob_inter, prob_last, prob_golden;
  int sign_bias_golden, sign_bias_alt;
  const uint8_t *y_mode_probs, *uv_mode_probs, *kf_b_mode_probs, *mv_probs;
  int8_t *ymode, *uvmode, *ref;
  int16_t *segment_update;
  uint8_t *skip, *y2_coded;
  int8_t *bmode;
  int16_t *sub_mv, *uv_mv;
  int8_t *splitmv_pid;
  int8_t *flipped;      /* R*C scratch */
  int8_t *bmode_above;  /* C*4 scratch */
  int8_t bmode_left[4];
};

inline void start_row(FrameHdrCtx &f) { memset(f.bmode_left, B_DC_PRED, 4); }

/* Parse one MB's header; returns 0 ok, -1 on error. */
inline int parse_one_mb(FrameHdrCtx &f, int r, int c) {
  BoolDecoder &bd = f.bd;
  const int R = f.R, C = f.C;
  const int mb = r * C + c;
  int8_t *mb_bmode = f.bmode + mb * 16;
  int16_t *mb_smv = f.sub_mv + mb * 32;

  if (f.read_segment_id)
    f.segment_update[mb] = (int16_t)bd.tree(kSegmentIdTree, f.seg_tree_probs);
  if (f.has_skip_prob) f.skip[mb] = (uint8_t)bd.get(f.prob_skip);

  if (f.key_frame) {
    const int ym = bd.tree(kKfYModeTree, kKfYModeProbs);
    f.ymode[mb] = (int8_t)ym;
    if (ym == B_PRED) {
      for (int sr = 0; sr < 4; sr++) {
        for (int sc = 0; sc < 4; sc++) {
          const int above = sr > 0 ? mb_bmode[(sr - 1) * 4 + sc]
                                   : f.bmode_above[c * 4 + sc];
          const int left = sc > 0 ? mb_bmode[sr * 4 + sc - 1]
                          : (c > 0 ? f.bmode[(mb - 1) * 16 + sr * 4 + 3]
                                   : f.bmode_left[sr]);
          mb_bmode[sr * 4 + sc] = (int8_t)bd.tree(
              kBModeTree, f.kf_b_mode_probs + (above * 10 + left) * 9);
        }
      }
    } else {
      memset(mb_bmode, kImpliedBMode[ym], 16);
    }
    for (int i = 0; i < 4; i++) {
      f.bmode_above[c * 4 + i] = mb_bmode[12 + i];
      f.bmode_left[i] = mb_bmode[i * 4 + 3];
    }
    f.uvmode[mb] = (int8_t)bd.tree(kUvModeTree, kKfUvModeProbs);
    f.y2_coded[mb] = ym != B_PRED;
    return 0;
  }

  /* interframe MB header */
  const int is_inter = bd.get(f.prob_inter);
  int rf = CUR_FRAME;
  if (is_inter) {
    if (bd.get(f.prob_last))
      rf = bd.get(f.prob_golden) ? ALTREF_FRAME : GOLDEN_FRAME;
    else
      rf = LAST_FRAME;
  }
  f.ref[mb] = (int8_t)rf;
  const int flip = (rf == GOLDEN_FRAME && f.sign_bias_golden) ||
                   (rf == ALTREF_FRAME && f.sign_bias_alt);
  f.flipped[mb] = (int8_t)flip;

  if (!is_inter) {
    const int ym = bd.tree(kYModeTree, f.y_mode_probs);
    f.ymode[mb] = (int8_t)ym;
    if (ym == B_PRED) {
      for (int i = 0; i < 16; i++)
        mb_bmode[i] = (int8_t)bd.tree(kBModeTree, kInvariantBModeProbs);
    } else {
      memset(mb_bmode, kImpliedBMode[ym], 16);
    }
    for (int i = 0; i < 4; i++) {
      f.bmode_above[c * 4 + i] = mb_bmode[12 + i];
      f.bmode_left[i] = mb_bmode[i * 4 + 3];
    }
    f.uvmode[mb] = (int8_t)bd.tree(kUvModeTree, f.uv_mode_probs);
    f.y2_coded[mb] = ym != B_PRED;
    return 0;
  }

  /* census (scorer.hh:36-79) */
  uint8_t scores[4] = {0, 0, 0, 0};
  MV mvs[4] = {{0, 0}, {0, 0}, {0, 0}, {0, 0}};
  uint8_t splitmv_score = 0;
  int index = 0;
  auto add = [&](uint8_t score, int rr, int cc) {
    if (rr < 0 || cc < 0) return;
    const int nmb = rr * C + cc;
    if (f.ref[nmb] == CUR_FRAME) return;
    MV mv{f.sub_mv[nmb * 32 + 15 * 2], f.sub_mv[nmb * 32 + 15 * 2 + 1]};
    if (f.flipped[nmb] != flip) {
      mv.x = -mv.x;
      mv.y = -mv.y;
    }
    if (mv.zero()) {
      scores[0] += score;
    } else {
      if (!(mv == mvs[index])) {
        index++;
        mvs[index] = mv;
      }
      scores[index] += score;
    }
    if (f.ymode[nmb] == SPLITMV) splitmv_score += score;
  };
  add(2, r - 1, c);
  add(2, r, c - 1);
  add(1, r - 1, c - 1);
  if (scores[3]) {
    if (mvs[index] == mvs[1]) scores[1] += scores[3];
  }
  if (scores[2] > scores[1]) {
    uint8_t ts = scores[1]; scores[1] = scores[2]; scores[2] = ts;
    MV tm = mvs[1]; mvs[1] = mvs[2]; mvs[2] = tm;
  }
  if (scores[1] >= scores[0]) mvs[0] = mvs[1];

  const uint8_t mv_ref_probs[4] = {
      kMvCountsToProbs[scores[0]][0], kMvCountsToProbs[scores[1]][1],
      kMvCountsToProbs[scores[2]][2], kMvCountsToProbs[splitmv_score][3]};

  const int ym = bd.tree(kMvRefTree, mv_ref_probs);
  f.ymode[mb] = (int8_t)ym;
  f.y2_coded[mb] = ym != SPLITMV;

  MV base{0, 0};
  bool have_base = true;
  switch (ym) {
    case NEARESTMV: base = clamp_mv(mvs[1], c, r, C, R); break;
    case NEARMV: base = clamp_mv(mvs[2], c, r, C, R); break;
    case ZEROMV: break;
    case NEWMV: {
      MV d = read_mv(bd, f.mv_probs);
      MV cb = clamp_mv(mvs[0], c, r, C, R);
      base = MV{(int16_t)(d.x + cb.x), (int16_t)(d.y + cb.y)};
      break;
    }
    case SPLITMV: {
      have_base = false;
      const int pid = bd.tree(kSplitMvTree, kSplitMvProbs);
      f.splitmv_pid[mb] = (int8_t)pid;
      const MvPartition &scheme = kMvPartitions[pid];
      const MV best = clamp_mv(mvs[0], c, r, C, R);
      int done[16] = {0};
      for (int sb = 0; sb < 16; sb++) {
        const int part = scheme.part_of[sb];
        if (done[part]) {
          /* copy from the partition's first subblock */
          continue;
        }
        done[part] = 1;
        const int sr = sb / 4, sc = sb % 4;
        MV left, above;
        if (sc > 0)
          left = MV{mb_smv[(sr * 4 + sc - 1) * 2],
                    mb_smv[(sr * 4 + sc - 1) * 2 + 1]};
        else if (c > 0)
          left = MV{f.sub_mv[(mb - 1) * 32 + (sr * 4 + 3) * 2],
                    f.sub_mv[(mb - 1) * 32 + (sr * 4 + 3) * 2 + 1]};
        else
          left = MV{0, 0};
        if (sr > 0)
          above = MV{mb_smv[((sr - 1) * 4 + sc) * 2],
                     mb_smv[((sr - 1) * 4 + sc) * 2 + 1]};
        else if (r > 0)
          above = MV{f.sub_mv[(mb - C) * 32 + (12 + sc) * 2],
                     f.sub_mv[(mb - C) * 32 + (12 + sc) * 2 + 1]};
        else
          above = MV{0, 0};

        int ctx;
        if (left == above && left.zero()) ctx = 4;
        else if (left == above) ctx = 3;
        else if (above.zero()) ctx = 2;
        else if (left.zero()) ctx = 1;
        else ctx = 0;

        const int sm = bd.tree(kSubmvRefTree, kSubmvRefProbs2[ctx]);
        MV mv;
        switch (sm) {
          case LEFT4X4: mv = left; break;
          case ABOVE4X4: mv = above; break;
          case ZERO4X4: mv = MV{0, 0}; break;
          default: { /* NEW4X4 */
            MV d = read_mv(bd, f.mv_probs);
            mv = MV{(int16_t)(d.x + best.x), (int16_t)(d.y + best.y)};
          }
        }
        /* write to every subblock of this partition */
        for (int k = 0; k < 16; k++) {
          if (scheme.part_of[k] == part) {
            mb_bmode[k] = (int8_t)sm;
            mb_smv[k * 2] = mv.x;
            mb_smv[k * 2 + 1] = mv.y;
          }
        }
      }
      break;
    }
    default:
      return -1;
  }

  if (have_base) {
    for (int k = 0; k < 16; k++) {
      mb_smv[k * 2] = base.x;
      mb_smv[k * 2 + 1] = base.y;
    }
    memset(mb_bmode, 0, 16);
  }

  /* chroma MVs (macroblock.cc:289-299, 446-455) */
  for (int ur = 0; ur < 2; ur++) {
    for (int uc = 0; uc < 2; uc++) {
      int sx = 0, sy = 0;
      const int idx[4] = {(ur * 2) * 4 + uc * 2, (ur * 2) * 4 + uc * 2 + 1,
                          (ur * 2 + 1) * 4 + uc * 2,
                          (ur * 2 + 1) * 4 + uc * 2 + 1};
      for (int k = 0; k < 4; k++) {
        sx += mb_smv[idx[k] * 2];
        sy += mb_smv[idx[k] * 2 + 1];
      }
      const int cx = sx >= 0 ? (sx + 4) >> 3 : -((-sx + 4) >> 3);
      const int cy = sy >= 0 ? (sy + 4) >> 3 : -((-sy + 4) >> 3);
      f.uv_mv[(mb * 4 + ur * 2 + uc) * 2] = (int16_t)cx;
      f.uv_mv[(mb * 4 + ur * 2 + uc) * 2 + 1] = (int16_t)cy;
    }
  }
  return 0;
}

} // namespace

extern "C" {

/* Returns final bool-decoder position state packed into out_state[4]
 * (pos, range, value, bit_count), or -1 on error. */
int vp8_parse_mb_headers(
    const uint8_t *fp_data, int64_t fp_size,
    int64_t pos, uint32_t range_, uint32_t value, int bit_count,
    int mb_rows, int mb_cols, int key_frame,
    /* header params */
    int read_segment_id, const uint8_t *seg_tree_probs,
    int has_skip_prob, uint8_t prob_skip,
    uint8_t prob_inter, uint8_t prob_last, uint8_t prob_golden,
    int sign_bias_golden, int sign_bias_alt,
    const uint8_t *y_mode_probs, const uint8_t *uv_mode_probs,
    const uint8_t *kf_b_mode_probs /* 10*10*9 */,
    const uint8_t *mv_probs /* 2*19 */,
    /* outputs (caller-zeroed) */
    int8_t *ymode, int8_t *uvmode, int8_t *ref, int16_t *segment_update,
    uint8_t *skip, uint8_t *y2_coded, int8_t *bmode /* r*c*16 */,
    int16_t *sub_mv /* r*c*16*2 */, int16_t *uv_mv /* r*c*4*2 */,
    int8_t *splitmv_pid /* r*c, -1 default */,
    int64_t *out_state) {
  const int R = mb_rows, C = mb_cols;
  FrameHdrCtx f;
  f.bd.data = fp_data;
  f.bd.size = fp_size;
  f.bd.pos = pos;
  f.bd.range_ = range_;
  f.bd.value = value;
  f.bd.bit_count = bit_count;
  f.R = R; f.C = C; f.key_frame = key_frame;
  f.read_segment_id = read_segment_id;
  f.seg_tree_probs = seg_tree_probs;
  f.has_skip_prob = has_skip_prob;
  f.prob_skip = prob_skip;
  f.prob_inter = prob_inter;
  f.prob_last = prob_last;
  f.prob_golden = prob_golden;
  f.sign_bias_golden = sign_bias_golden;
  f.sign_bias_alt = sign_bias_alt;
  f.y_mode_probs = y_mode_probs;
  f.uv_mode_probs = uv_mode_probs;
  f.kf_b_mode_probs = kf_b_mode_probs;
  f.mv_probs = mv_probs;
  f.ymode = ymode; f.uvmode = uvmode; f.ref = ref;
  f.segment_update = segment_update;
  f.skip = skip; f.y2_coded = y2_coded; f.bmode = bmode;
  f.sub_mv = sub_mv; f.uv_mv = uv_mv; f.splitmv_pid = splitmv_pid;
  f.flipped = new int8_t[R * C]();
  f.bmode_above = new int8_t[C * 4]();  /* B_DC_PRED = 0 */

  int rc = 0;
  for (int r = 0; r < R && rc == 0; r++) {
    start_row(f);
    for (int c = 0; c < C; c++) {
      if ((rc = parse_one_mb(f, r, c)) != 0) break;
    }
  }

  delete[] f.flipped;
  delete[] f.bmode_above;
  if (rc != 0) return -1;
  out_state[0] = f.bd.pos;
  out_state[1] = f.bd.range_;
  out_state[2] = f.bd.value;
  out_state[3] = f.bd.bit_count;
  return 0;
}

} // extern "C" — the range worker below is internal

/* Worker: parse the stream range [g0, g1) of the batch, interleaving the
 * range's independent bool-decoder chains MB-by-MB so they overlap in the
 * out-of-order core.  All mutable state (contexts, outputs, decoders) is
 * per-frame disjoint, so disjoint ranges run on separate threads with
 * bit-identical output (same structure as bitwork.cc parse_tokens_range). */
static int parse_headers_range(
    int g0, int g1, int mb_rows, int mb_cols,
    const uint8_t *data, const int64_t *off, int64_t *states,
    const int32_t *params,
    const uint8_t *seg_tree_probs, const uint8_t *y_mode_probs,
    const uint8_t *uv_mode_probs, const uint8_t *kf_b_mode_probs,
    const uint8_t *mv_probs,
    int8_t *ymode, int8_t *uvmode, int8_t *ref, int16_t *segment_update,
    uint8_t *skip, uint8_t *y2_coded, int8_t *bmode,
    int16_t *sub_mv, int16_t *uv_mv, int8_t *splitmv_pid) {
  const int R = mb_rows, C = mb_cols;
  const int64_t n = (int64_t)R * C;
  FrameHdrCtx fs[32];
  for (int g = g0; g < g1; g++) {
    FrameHdrCtx &f = fs[g];
    const int32_t *p = params + g * 12;
    f.bd.data = data + off[g];
    f.bd.size = off[g + 1] - off[g];
    f.bd.pos = states[g * 4 + 0];
    f.bd.range_ = (uint32_t)states[g * 4 + 1];
    f.bd.value = (uint32_t)states[g * 4 + 2];
    f.bd.bit_count = (int)states[g * 4 + 3];
    f.R = R; f.C = C;
    f.key_frame = p[0];
    f.read_segment_id = p[1];
    f.has_skip_prob = p[2];
    f.prob_skip = (uint8_t)p[3];
    f.prob_inter = (uint8_t)p[4];
    f.prob_last = (uint8_t)p[5];
    f.prob_golden = (uint8_t)p[6];
    f.sign_bias_golden = p[7];
    f.sign_bias_alt = p[8];
    f.seg_tree_probs = seg_tree_probs + g * 3;
    f.y_mode_probs = y_mode_probs + g * 4;
    f.uv_mode_probs = uv_mode_probs + g * 3;
    f.kf_b_mode_probs = kf_b_mode_probs;
    f.mv_probs = mv_probs + g * 2 * 19;
    f.ymode = ymode + g * n;
    f.uvmode = uvmode + g * n;
    f.ref = ref + g * n;
    f.segment_update = segment_update + g * n;
    f.skip = skip + g * n;
    f.y2_coded = y2_coded + g * n;
    f.bmode = bmode + g * n * 16;
    f.sub_mv = sub_mv + g * n * 32;
    f.uv_mv = uv_mv + g * n * 8;
    f.splitmv_pid = splitmv_pid + g * n;
    f.flipped = new int8_t[n]();
    f.bmode_above = new int8_t[C * 4]();
  }

  int rc = 0;
  for (int r = 0; r < R && rc == 0; r++) {
    for (int g = g0; g < g1; g++) start_row(fs[g]);
    for (int c = 0; c < C && rc == 0; c++) {
      for (int g = g0; g < g1; g++) {
        if (parse_one_mb(fs[g], r, c) != 0) { rc = -1; break; }
      }
    }
  }

  for (int g = g0; g < g1; g++) {
    states[g * 4 + 0] = fs[g].bd.pos;
    states[g * 4 + 1] = fs[g].bd.range_;
    states[g * 4 + 2] = fs[g].bd.value;
    states[g * 4 + 3] = fs[g].bd.bit_count;
    delete[] fs[g].flipped;
    delete[] fs[g].bmode_above;
  }
  return rc;
}

extern "C" {

/* GOP-batched MB-header parse: G frames interleaved MB-by-MB (see
 * parse_headers_range).
 *
 * Scalar per-frame params arrive packed in params (G, 12) int32:
 *   {key_frame, read_segment_id, has_skip_prob, prob_skip, prob_inter,
 *    prob_last, prob_golden, sign_bias_golden, sign_bias_alt, 0, 0, 0}
 * Decoder states: states (G, 4) int64 {pos, range, value, bit_count},
 * updated in place.  data/off: concatenated first partitions.  Prob
 * tables are contiguous (G, ...) slabs; outputs are (G, R*C, ...) slabs.
 * Returns 0 or -1. */
int vp8_parse_mb_headers_gop(
    int G, int mb_rows, int mb_cols,
    const uint8_t *data, const int64_t *off, int64_t *states,
    const int32_t *params,
    const uint8_t *seg_tree_probs /* (G,3) */,
    const uint8_t *y_mode_probs /* (G,4) */,
    const uint8_t *uv_mode_probs /* (G,3) */,
    const uint8_t *kf_b_mode_probs /* 10*10*9, shared */,
    const uint8_t *mv_probs /* (G,2*19) */,
    int8_t *ymode, int8_t *uvmode, int8_t *ref, int16_t *segment_update,
    uint8_t *skip, uint8_t *y2_coded, int8_t *bmode,
    int16_t *sub_mv, int16_t *uv_mv, int8_t *splitmv_pid) {
  if (G < 1 || G > 32) return -1;
  return parse_headers_range(0, G, mb_rows, mb_cols, data, off, states,
                             params, seg_tree_probs, y_mode_probs,
                             uv_mode_probs, kf_b_mode_probs, mv_probs,
                             ymode, uvmode, ref, segment_update, skip,
                             y2_coded, bmode, sub_mv, uv_mv, splitmv_pid);
}

/* Multithreaded variant: contiguous stream ranges fan out over OS threads
 * (bit-identical to the serial call; the range decoder chains are per-
 * stream, so only core count limits scaling).  threads <= 1 or G == 1
 * falls back to the serial interleaved loop. */
int vp8_parse_mb_headers_gop_mt(
    int threads, int G, int mb_rows, int mb_cols,
    const uint8_t *data, const int64_t *off, int64_t *states,
    const int32_t *params,
    const uint8_t *seg_tree_probs, const uint8_t *y_mode_probs,
    const uint8_t *uv_mode_probs, const uint8_t *kf_b_mode_probs,
    const uint8_t *mv_probs,
    int8_t *ymode, int8_t *uvmode, int8_t *ref, int16_t *segment_update,
    uint8_t *skip, uint8_t *y2_coded, int8_t *bmode,
    int16_t *sub_mv, int16_t *uv_mv, int8_t *splitmv_pid) {
  if (G < 1 || G > 32) return -1;
  if (threads > G) threads = G;
  if (threads <= 1)
    return parse_headers_range(0, G, mb_rows, mb_cols, data, off, states,
                               params, seg_tree_probs, y_mode_probs,
                               uv_mode_probs, kf_b_mode_probs, mv_probs,
                               ymode, uvmode, ref, segment_update, skip,
                               y2_coded, bmode, sub_mv, uv_mv, splitmv_pid);
  std::vector<std::thread> ts;
  std::vector<int> rcs(threads, 0);
  for (int t = 0; t < threads; t++) {
    const int lo = (int)((int64_t)G * t / threads);
    const int hi = (int)((int64_t)G * (t + 1) / threads);
    if (lo == hi) continue;
    ts.emplace_back([=, &rcs]() {
      rcs[t] = parse_headers_range(lo, hi, mb_rows, mb_cols, data, off,
                                   states, params, seg_tree_probs,
                                   y_mode_probs, uv_mode_probs,
                                   kf_b_mode_probs, mv_probs, ymode, uvmode,
                                   ref, segment_update, skip, y2_coded,
                                   bmode, sub_mv, uv_mv, splitmv_pid);
    });
  }
  for (auto &th : ts) th.join();
  for (int t = 0; t < threads; t++)
    if (rcs[t] != 0) return -1;
  return 0;
}

} // extern "C"
