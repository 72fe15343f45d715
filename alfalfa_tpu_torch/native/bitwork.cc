/* bitwork: native host-side bit-serial kernels for the codec framework.
 *
 * The entropy layer of VP8 is inherently sequential (RFC 6386 section 7);
 * it runs on the host CPU while the pixel pipeline runs on the GPU.  This
 * library implements the hot host loops:
 *   - vp8_parse_tokens: coefficient token decode for a whole frame
 *     (semantics of reference decoder/tokens.cc:50-135 + frame.cc:121-137)
 *   - vp8_hash_range: golden-ratio hash combine over arrays (state hashing)
 *
 * Exposed via a plain C ABI and loaded with ctypes (no pybind11 in image).
 */
#include <cstdint>
#include <cstring>
#include <atomic>
#include <thread>
#include <vector>

namespace {

/* Simple octet-at-a-time decoder; state layout matches the Python
 * BoolDecoder exactly so mid-stream resume (header fast paths) is a plain
 * field copy. */
struct BoolDecoder {
  const uint8_t *data;
  int64_t pos, size;
  uint32_t range_, value;
  int bit_count;

  void init(const uint8_t *d, int64_t n) {
    data = d;
    pos = 0;
    size = n;
    range_ = 255;
    value = 0;
    bit_count = 0;
    load_octet();
    value <<= 8;
    load_octet();
  }

  inline void load_octet() {
    if (pos < size) value |= data[pos++];
    /* complete chunks zero-extend silently (bool_decoder.hh:56-65) */
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
};

/* leading-shift table: number of left-shifts to renormalize range into
 * [128, 255] (libvpx vp8_norm) */
constexpr uint8_t kNorm(int i) {
  return i < 1 ? 0 : i < 2 ? 7 : i < 4 ? 6 : i < 8 ? 5 : i < 16 ? 4
       : i < 32 ? 3 : i < 64 ? 2 : i < 128 ? 1 : 0;
}

struct NormTable {
  uint8_t v[256];
  constexpr NormTable() : v() {
    for (int i = 0; i < 256; i++) v[i] = kNorm(i);
  }
};
constexpr NormTable kNormTable;

/* Fast decoder for the token-parse hot loop: 64-bit left-aligned value
 * window, eager byte fill, table-driven renormalization (the structure of
 * libvpx dboolhuff, re-derived).  Zero-extends past the end like the
 * reference's tolerant BoolDecoder.  Internal to this library only — its
 * state is never exported to Python. */
struct FastBool {
  const uint8_t *data;
  int64_t pos, size;
  uint32_t range_;
  uint64_t value;  /* active window in the TOP bits */
  int count;       /* valid bits in value minus 8 */

  void init(const uint8_t *d, int64_t n) {
    data = d;
    pos = 0;
    size = n;
    range_ = 255;
    value = 0;
    count = -8;
    fill();
  }

  inline void fill() {
    int shift = 48 - count; /* = 64 - 8 - (count + 8) */
    if (pos + 8 <= size) {
      /* bulk refill: one big-endian 64-bit load places every whole byte
       * that fits under the window (bits below the last byte masked off
       * so later refills still OR into zeros) */
      uint64_t big;
      memcpy(&big, data + pos, 8);
      big = __builtin_bswap64(big);
      const int nbytes = (shift >> 3) + 1;
      value |= (big >> (56 - shift)) & (~0ULL << (shift & 7));
      pos += nbytes;
      count += nbytes << 3;
      return;
    }
    while (shift >= 0) {
      uint64_t b = pos < size ? data[pos] : 0;
      pos++; /* virtual position keeps bit accounting uniform past EOS */
      value |= b << shift;
      shift -= 8;
      count += 8;
    }
  }

  inline int get(int probability) {
    const uint32_t split = 1 + (((range_ - 1) * (uint32_t)probability) >> 8);
    const uint64_t big_split = (uint64_t)split << 56;
    /* branchless select: the outcome of a coded bool is data-dependent
     * noise, so a cmov beats a ~50% mispredict */
    const int ret = value >= big_split;
    const uint32_t range = ret ? range_ - split : split;
    value -= ret ? big_split : 0;
    const int shift = kNormTable.v[range];
    value <<= shift;
    range_ = range << shift;
    count -= shift;
    if (count < 0) fill();
    return ret;
  }
};

constexpr uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
constexpr uint8_t kBand[16] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7};

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

/* Sparse coefficient sink: flat indices into the (mb, 25, 16) dense layout
 * plus values; lets the host skip materializing ~3 MB of dense zeros per
 * 720p frame when only the scatter list is needed. */
struct SparseSink {
  int32_t *idx;
  int16_t *val;
  int64_t count, cap;
  int64_t base; /* dense offset of the current block's 16 coeffs */
};

/* parse_block variant for the GOP hot loop: writes values into out16 at
 * dense positions WITHOUT zero-initialization and returns a bitmask of
 * set dense positions (0 == all-zero block); the caller walks set bits
 * only.  Keeps the coefficient semantics of parse_block below. */
inline uint32_t parse_block_mask(FastBool &bd, const uint8_t *probs_bt,
                                 int ctx, int first, int16_t *out16) {
  uint32_t mask = 0;
  bool last_was_zero = false;
  int token_context = ctx;

  for (int index = first; index < 16; index++) {
    const uint8_t *prob = probs_bt + (kBand[index] * 3 + token_context) * 11;
    if (!last_was_zero) {
      if (!bd.get(prob[0])) break; /* EOB */
    }
    if (!bd.get(prob[1])) {
      last_was_zero = true;
      token_context = 0;
      continue;
    }
    last_was_zero = false;
    int value;
    if (!bd.get(prob[2])) {
      value = 1;
      token_context = 1;
    } else {
      token_context = 2;
      if (!bd.get(prob[3])) {
        if (!bd.get(prob[4])) {
          value = 2;
        } else {
          value = bd.get(prob[5]) ? 4 : 3;
        }
      } else {
        int cat;
        if (!bd.get(prob[6])) {
          if (!bd.get(prob[7])) {
            value = 5 + bd.get(159);
            cat = -1;
          } else {
            cat = 0;
          }
        } else {
          if (!bd.get(prob[8])) {
            cat = bd.get(prob[9]) ? 2 : 1;
          } else {
            cat = bd.get(prob[10]) ? 4 : 3;
          }
        }
        if (cat >= 0) {
          const TokenExtra &te = kExtra[cat];
          int extra = 0;
          for (int i = 0; i < te.nbits; i++) {
            extra = (extra << 1) + bd.get(te.probs[i]);
          }
          value = te.base + extra;
        }
      }
    }
    const int sign = bd.get(128);
    value = (value ^ -sign) + sign; /* branchless negate */
    const int dpos = kZigzag[index];
    out16[dpos] = (int16_t)value;
    mask |= 1u << dpos;
  }
  return mask;
}

/* Returns 1 if the block has any nonzero coefficient. coeff_probs indexed
 * [block_type][band][ctx][node] = ((bt*8 + band)*3 + ctx)*11 + node. */
inline int parse_block(FastBool &bd, const uint8_t *coeff_probs,
                       int block_type, int ctx, int first, int16_t *out16,
                       SparseSink *sink) {
  const uint8_t *probs_bt = coeff_probs + block_type * 8 * 3 * 11;
  int has_nonzero = 0;
  bool last_was_zero = false;
  int token_context = ctx;

  for (int index = first; index < 16; index++) {
    const uint8_t *prob = probs_bt + (kBand[index] * 3 + token_context) * 11;
    if (!last_was_zero) {
      if (!bd.get(prob[0])) break; /* EOB */
    }
    if (!bd.get(prob[1])) {
      last_was_zero = true;
      token_context = 0;
      continue;
    }
    last_was_zero = false;
    has_nonzero = 1;
    int value;
    if (!bd.get(prob[2])) {
      value = 1;
      token_context = 1;
    } else {
      token_context = 2;
      if (!bd.get(prob[3])) {
        if (!bd.get(prob[4])) {
          value = 2;
        } else {
          value = bd.get(prob[5]) ? 4 : 3;
        }
      } else {
        int cat;
        if (!bd.get(prob[6])) {
          if (!bd.get(prob[7])) {
            value = 5 + bd.get(159);
            cat = -1;
          } else {
            cat = 0;
          }
        } else {
          if (!bd.get(prob[8])) {
            cat = bd.get(prob[9]) ? 2 : 1;
          } else {
            cat = bd.get(prob[10]) ? 4 : 3;
          }
        }
        if (cat >= 0) {
          const TokenExtra &te = kExtra[cat];
          int extra = 0;
          for (int i = 0; i < te.nbits; i++) {
            extra = (extra << 1) + bd.get(te.probs[i]);
          }
          value = te.base + extra;
        }
      }
    }
    const int sign = bd.get(128);
    value = (value ^ -sign) + sign; /* branchless negate */
    if (out16) out16[kZigzag[index]] = (int16_t)value;
    if (sink && sink->count < sink->cap) {
      sink->idx[sink->count] = (int32_t)(sink->base + kZigzag[index]);
      sink->val[sink->count] = (int16_t)value;
      sink->count++;
    }
  }
  return has_nonzero;
}

} // namespace

/* Shared single-frame token state: context planes are written by the
 * owning MB row and read by the row below (the serial path trivially
 * satisfies that order; the wavefront-MT path enforces it with per-row
 * progress counters). */
struct TokenFrameCtx {
  int R, C;
  const uint8_t *coeff_probs, *skip, *y2_coded;
  int16_t *coeffs;                       /* dense out, or null */
  uint8_t *has_nonzero_out;
  uint8_t *y_nz, *u_nz, *v_nz;
  uint8_t *y2_above, *y2_above_valid;
};

/* One MB row of the token parse.  wait(c)/done(c) are the wavefront
 * hooks (no-ops in the serial path): wait blocks until MB (r-1, c) is
 * complete, done publishes MB (r, c). */
template <class WaitFn, class DoneFn>
inline void process_token_row(const TokenFrameCtx &F, int r, FastBool &bd,
                              SparseSink *sink, WaitFn wait, DoneFn done) {
  const int C = F.C;
  uint8_t y2_left = 0, y2_left_valid = 0;
  for (int c = 0; c < C; c++) {
    wait(c);
    const int mb = r * C + c;
    const int64_t mb_base = (int64_t)mb * 25 * 16;
    int16_t *mb_coeffs = F.coeffs ? F.coeffs + mb_base : nullptr;
    const int y2c = F.y2_coded[mb];

    if (F.skip[mb]) {
      /* contexts cleared; has_nonzero stays 0 */
      for (int sr = 0; sr < 4; sr++)
        memset(F.y_nz + (r * 4 + sr) * C * 4 + c * 4, 0, 4);
      for (int sr = 0; sr < 2; sr++) {
        memset(F.u_nz + (r * 2 + sr) * C * 2 + c * 2, 0, 2);
        memset(F.v_nz + (r * 2 + sr) * C * 2 + c * 2, 0, 2);
      }
      if (y2c) {
        F.y2_above[c] = 0;
        F.y2_above_valid[c] = 1;
        y2_left = 0;
        y2_left_valid = 1;
      }
      done(c);
      continue;
    }

    int mb_nonzero = 0;
    if (y2c) {
      const int ctx = (F.y2_above_valid[c] ? F.y2_above[c] : 0) +
                      (y2_left_valid ? y2_left : 0);
      if (sink) sink->base = mb_base + 24 * 16;
      const int nz = parse_block(bd, F.coeff_probs, 1 /*Y2*/, ctx, 0,
                                 mb_coeffs ? mb_coeffs + 24 * 16 : nullptr,
                                 sink);
      F.y2_above[c] = (uint8_t)nz;
      F.y2_above_valid[c] = 1;
      y2_left = (uint8_t)nz;
      y2_left_valid = 1;
      mb_nonzero |= nz;
    }

    const int block_type = y2c ? 0 /*Y_after_Y2*/ : 3 /*Y_without_Y2*/;
    const int first = y2c ? 1 : 0;
    for (int sr = 0; sr < 4; sr++) {
      for (int sc = 0; sc < 4; sc++) {
        const int gr = r * 4 + sr, gc = c * 4 + sc;
        const int ctx = (gr > 0 ? F.y_nz[(gr - 1) * C * 4 + gc] : 0) +
                        (gc > 0 ? F.y_nz[gr * C * 4 + gc - 1] : 0);
        if (sink) sink->base = mb_base + (sr * 4 + sc) * 16;
        const int nz = parse_block(
            bd, F.coeff_probs, block_type, ctx, first,
            mb_coeffs ? mb_coeffs + (sr * 4 + sc) * 16 : nullptr, sink);
        F.y_nz[gr * C * 4 + gc] = (uint8_t)nz;
        mb_nonzero |= nz;
      }
    }

    uint8_t *nz_planes[2] = {F.u_nz, F.v_nz};
    for (int plane = 0; plane < 2; plane++) {
      uint8_t *nzp = nz_planes[plane];
      const int base = 16 + plane * 4;
      for (int sr = 0; sr < 2; sr++) {
        for (int sc = 0; sc < 2; sc++) {
          const int gr = r * 2 + sr, gc = c * 2 + sc;
          const int ctx = (gr > 0 ? nzp[(gr - 1) * C * 2 + gc] : 0) +
                          (gc > 0 ? nzp[gr * C * 2 + gc - 1] : 0);
          if (sink) sink->base = mb_base + (base + sr * 2 + sc) * 16;
          const int nz = parse_block(
              bd, F.coeff_probs, 2 /*UV*/, ctx, 0,
              mb_coeffs ? mb_coeffs + (base + sr * 2 + sc) * 16 : nullptr,
              sink);
          nzp[gr * C * 2 + gc] = (uint8_t)nz;
          mb_nonzero |= nz;
        }
      }
    }
    F.has_nonzero_out[mb] = (uint8_t)mb_nonzero;
    done(c);
  }
}

struct TokenPlanes {
  uint8_t *y_nz, *u_nz, *v_nz, *y2_above, *y2_above_valid;
  TokenPlanes(int R, int C)
      : y_nz(new uint8_t[(size_t)R * 4 * C * 4]()),
        u_nz(new uint8_t[(size_t)R * 2 * C * 2]()),
        v_nz(new uint8_t[(size_t)R * 2 * C * 2]()),
        y2_above(new uint8_t[C]()),
        y2_above_valid(new uint8_t[C]()) {}
  ~TokenPlanes() {
    delete[] y_nz;
    delete[] u_nz;
    delete[] v_nz;
    delete[] y2_above;
    delete[] y2_above_valid;
  }
};

extern "C" {

/* coeffs may be NULL (skip dense output); sparse_* may be NULL (skip
 * sparse output).  sparse_meta = {count_out, capacity}; returns -2 if the
 * sparse capacity was exceeded (output truncated). */
int vp8_parse_tokens(const uint8_t *part_data, const int64_t *part_offsets,
                     int num_parts, int mb_rows, int mb_cols,
                     const uint8_t *coeff_probs, const uint8_t *skip,
                     const uint8_t *y2_coded, int16_t *coeffs,
                     uint8_t *has_nonzero_out,
                     int32_t *sparse_idx, int16_t *sparse_val,
                     int64_t *sparse_meta) {
  FastBool decs[8];
  if (num_parts < 1 || num_parts > 8) return -1;
  SparseSink sink_storage{sparse_idx, sparse_val, 0,
                          sparse_meta ? sparse_meta[1] : 0, 0};
  SparseSink *sink = (sparse_idx && sparse_val && sparse_meta)
                         ? &sink_storage : nullptr;
  for (int i = 0; i < num_parts; i++) {
    decs[i].init(part_data + part_offsets[i],
                 part_offsets[i + 1] - part_offsets[i]);
  }

  const int C = mb_cols, R = mb_rows;
  TokenPlanes P(R, C);
  const TokenFrameCtx F{R, C, coeff_probs, skip, y2_coded, coeffs,
                        has_nonzero_out, P.y_nz, P.u_nz, P.v_nz,
                        P.y2_above, P.y2_above_valid};
  for (int r = 0; r < R; r++)
    process_token_row(F, r, decs[r % num_parts], sink,
                      [](int) {}, [](int) {});
  if (sink) {
    sparse_meta[0] = sink->count;
    if (sink->count >= sink->cap) return -2; /* truncated */
  }
  return 0;
}

/* Wavefront-parallel token parse across DCT partitions: the up-to-8
 * token partitions are independent range-decoder chains over alternating
 * MB rows (reference decoder/frame.cc:131-136 decodes them serially);
 * one thread per partition, with MB (r, c) gated on MB (r-1, c) via
 * per-row progress counters — the nonzero-context dependency points
 * up and left only.  Sparse output lands in per-row segments (bounded
 * by the row's dense size, so workers can't overflow) merged in raster
 * order afterwards; identical to vp8_parse_tokens bit for bit.
 * This is the §2.9 row-partition parallelism the reference leaves on
 * the table, applied to single-stream decode. */
int vp8_parse_tokens_mt(int threads,
                        const uint8_t *part_data, const int64_t *part_offsets,
                        int num_parts, int mb_rows, int mb_cols,
                        const uint8_t *coeff_probs, const uint8_t *skip,
                        const uint8_t *y2_coded, int16_t *coeffs,
                        uint8_t *has_nonzero_out,
                        int32_t *sparse_idx, int16_t *sparse_val,
                        int64_t *sparse_meta) {
  if (num_parts < 2 || threads <= 1)
    return vp8_parse_tokens(part_data, part_offsets, num_parts, mb_rows,
                            mb_cols, coeff_probs, skip, y2_coded, coeffs,
                            has_nonzero_out, sparse_idx, sparse_val,
                            sparse_meta);
  if (num_parts > 8) return -1;
  if (threads > num_parts) threads = num_parts;
  const int C = mb_cols, R = mb_rows;
  const bool want_sparse = sparse_idx && sparse_val && sparse_meta;

  FastBool decs[8];
  for (int i = 0; i < num_parts; i++)
    decs[i].init(part_data + part_offsets[i],
                 part_offsets[i + 1] - part_offsets[i]);
  TokenPlanes P(R, C);
  const TokenFrameCtx F{R, C, coeff_probs, skip, y2_coded, coeffs,
                        has_nonzero_out, P.y_nz, P.u_nz, P.v_nz,
                        P.y2_above, P.y2_above_valid};

  /* per-row sparse segments, bounded by the row's dense coefficient
   * count — a worker can never overflow its segment */
  const int64_t row_cap = (int64_t)C * 400;
  std::vector<int32_t> ridx;
  std::vector<int16_t> rval;
  std::vector<SparseSink> rsink(R);
  if (want_sparse) {
    ridx.resize((size_t)R * row_cap);
    rval.resize((size_t)R * row_cap);
    for (int r = 0; r < R; r++)
      rsink[r] = SparseSink{ridx.data() + (size_t)r * row_cap,
                            rval.data() + (size_t)r * row_cap, 0, row_cap,
                            0};
  }

  std::vector<std::atomic<int>> progress(R);
  for (int r = 0; r < R; r++) progress[r].store(-1);

  auto worker = [&](int t) {
    /* ascending global row order per thread (wavefront: row r waits only
     * on r-1, whose owner is also ascending — no deadlock) */
    for (int r = 0; r < R; r++) {
      if ((r % num_parts) % threads != t) continue;
      auto wait = [&](int c) {
        if (r == 0) return;
        int spins = 0;
        while (progress[r - 1].load(std::memory_order_acquire) < c) {
#if defined(__x86_64__)
          __builtin_ia32_pause();
#endif
          if (++spins > 4096) {
            std::this_thread::yield();
            spins = 0;
          }
        }
      };
      auto done = [&](int c) {
        progress[r].store(c, std::memory_order_release);
      };
      process_token_row(F, r, decs[r % num_parts],
                        want_sparse ? &rsink[r] : nullptr, wait, done);
    }
  };
  std::vector<std::thread> ts;
  for (int t = 1; t < threads; t++) ts.emplace_back(worker, t);
  worker(0);
  for (auto &th : ts) th.join();

  if (want_sparse) {
    int64_t total = 0;
    for (int r = 0; r < R; r++) total += rsink[r].count;
    sparse_meta[0] = total;
    if (total > sparse_meta[1]) return -2;
    int64_t w = 0;
    for (int r = 0; r < R; r++) {
      memcpy(sparse_idx + w, rsink[r].idx, rsink[r].count * sizeof(int32_t));
      memcpy(sparse_val + w, rsink[r].val, rsink[r].count * sizeof(int16_t));
      w += rsink[r].count;
    }
  }
  return 0;
}

/* GOP-batched token parse: G frames' DCT partitions decoded in ONE call
 * with block-level interleaving across the (independent) streams.  The
 * range decoder is a serial dependency chain (~10 cycles/bit); round-
 * robining blocks across G streams gives the out-of-order core G
 * independent chains, which is worth ~2-3x on top of the single-stream
 * loop.  This is the host-side mirror of the device's GOP-lockstep decode
 * (parallel/gop.py): same batch, same layout.
 *
 * Layout: data = all partitions of all frames concatenated; frame g's
 * partition p spans [offsets[part_base[g]+p], offsets[part_base[g]+p+1]).
 * coeff_probs: (G, 4*8*3*11); skip/y2_coded/has_nonzero: (G, R*C).
 *
 * Sparse output is a COMPACT STREAM: host->device bytes are the upload's cost,
 * so nonzero coefficients ship as
 * 2 bytes each — a u8 index DELTA (global index g*R*C*400 + mb*400 +
 * block*16 + pos, strictly ascending; coefficients are emitted in
 * position order) and an i8 value — plus two small escape lists for
 * deltas > 255 and |value| > 127: (position-in-stream, extra) pairs
 * the device scatters before its prefix-sum.  Output is written into
 * per-frame segments [seg_base[g], seg_base[g+1]); the FIRST delta of
 * each segment is relative to that frame's base element g*R*C*400 - 1
 * (the host patches segment boundaries after compaction).
 * seg_meta layout: [0..G] segment bases (in), [G+1..2G] counts (out),
 * [2G+1..3G+1] escape-list bases (in), [3G+2..4G+1] delta-escape counts
 * (out), [4G+2..5G+1] value-escape counts (out), [5G+2..6G+1] last
 * emitted global index per segment (out; lets the host re-base segment
 * boundaries when compacting).
 *
 * parse_tokens_range is the worker: it parses the stream range [g0, g1)
 * of the batch.  Every output and every piece of mutable state (segments,
 * escape lists, nz-context planes, decoders) is per-frame disjoint, so
 * disjoint ranges can run on separate threads (vp8_parse_tokens_gop_mt)
 * and produce bit-identical results to the serial call.
 * Returns true if any segment or escape list overflowed. */
constexpr int kMaxG = 32;   /* widest GOP lockstep batch */

static bool parse_tokens_range(
                         int g0, int g1, int G, int mb_rows, int mb_cols,
                         const uint8_t *data, const int64_t *offsets,
                         const int32_t *nparts, const int32_t *part_base,
                         const uint8_t *coeff_probs, const uint8_t *skip,
                         const uint8_t *y2_coded, uint8_t *has_nonzero_out,
                         uint8_t *sp_delta, int8_t *sp_val,
                         int32_t *desc_pos, int32_t *desc_extra,
                         int32_t *vesc_pos, int16_t *vesc_val,
                         int64_t *seg_meta) {
  const int R = mb_rows, C = mb_cols;
  FastBool decs[kMaxG][8];
  for (int g = g0; g < g1; g++) {
    for (int p = 0; p < nparts[g]; p++) {
      const int64_t b = offsets[part_base[g] + p];
      decs[g][p].init(data + b, offsets[part_base[g] + p + 1] - b);
    }
  }
  const int64_t *seg_base = seg_meta;
  int64_t *seg_count = seg_meta + G + 1;
  const int64_t *esc_base = seg_meta + 2 * G + 1;   /* G+1 entries */
  int64_t *desc_count = seg_meta + 3 * G + 2;
  int64_t *vesc_count = seg_meta + 4 * G + 2;
  int64_t *last_out = seg_meta + 5 * G + 2;
  int64_t seg_pos[kMaxG], desc_pos_g[kMaxG], vesc_pos_g[kMaxG],
      last_idx[kMaxG];
  bool overflow = false;
  const int64_t felems = (int64_t)mb_rows * mb_cols * 400;
  for (int g = g0; g < g1; g++) {
    seg_pos[g] = seg_base[g];
    desc_pos_g[g] = vesc_pos_g[g] = esc_base[g];
    last_idx[g] = g * felems - 1;
  }
  /* emit the block's nonzero coefficients (set bits of mask) in ascending
   * position order; tmp is only valid at set positions */
  auto emit_block = [&](int g, int64_t base_elem, const int16_t *tmp,
                        uint32_t mask) {
    int64_t p = seg_pos[g];
    const int64_t lim = seg_base[g + 1];
    const int64_t esc_lim = esc_base[g + 1];
    int64_t last = last_idx[g];
    while (mask) {
      const int i = __builtin_ctz(mask);
      mask &= mask - 1;
      if (p >= lim) { overflow = true; return; }
      const int64_t idx = base_elem + i;
      int64_t d = idx - last;
      if (d > 255) {
        if (desc_pos_g[g] >= esc_lim) { overflow = true; return; }
        desc_pos[desc_pos_g[g]] = (int32_t)p;
        desc_extra[desc_pos_g[g]] = (int32_t)(d - 255);
        desc_pos_g[g]++;
        d = 255;
      }
      int v = tmp[i];
      if (v < -128 || v > 127) {
        if (vesc_pos_g[g] >= esc_lim) { overflow = true; return; }
        vesc_pos[vesc_pos_g[g]] = (int32_t)p;
        vesc_val[vesc_pos_g[g]] = (int16_t)v;
        vesc_pos_g[g]++;
        v = 0;
      }
      sp_delta[p] = (uint8_t)d;
      sp_val[p] = (int8_t)v;
      last = idx;
      p++;
    }
    last_idx[g] = last;
    seg_pos[g] = p;
  };

  /* per-frame context planes, packed [g][...] */
  uint8_t *y_nz = new uint8_t[(size_t)G * R * 4 * C * 4]();
  uint8_t *u_nz = new uint8_t[(size_t)G * R * 2 * C * 2]();
  uint8_t *v_nz = new uint8_t[(size_t)G * R * 2 * C * 2]();
  uint8_t *y2_above = new uint8_t[(size_t)G * C]();
  uint8_t *y2_above_valid = new uint8_t[(size_t)G * C]();
  uint8_t y2_left[kMaxG], y2_left_valid[kMaxG];
  FastBool *bd_row[kMaxG];
  /* per-(g) per-MB scratch */
  uint8_t live[kMaxG];     /* not skipped */
  uint32_t y2_pend[kMaxG]; /* buffered Y2 mask awaiting ordered emission */
  int16_t y2_tmp[kMaxG * 16];
  int mb_nz[kMaxG];

  for (int r = 0; r < R; r++) {
    for (int g = g0; g < g1; g++) {
      bd_row[g] = &decs[g][r % nparts[g]];
      y2_left[g] = 0;
      y2_left_valid[g] = 0;
    }
    for (int c = 0; c < C; c++) {
      const int mb = r * C + c;
      /* phase 0: skips + Y2 blocks (independent across g) */
      for (int g = g0; g < g1; g++) {
        const int gmb = g * R * C + mb;
        mb_nz[g] = 0;
        if (skip[gmb]) {
          live[g] = 0;
          uint8_t *yg = y_nz + (size_t)g * R * 4 * C * 4;
          for (int sr = 0; sr < 4; sr++)
            memset(yg + (r * 4 + sr) * C * 4 + c * 4, 0, 4);
          uint8_t *ug = u_nz + (size_t)g * R * 2 * C * 2;
          uint8_t *vg = v_nz + (size_t)g * R * 2 * C * 2;
          for (int sr = 0; sr < 2; sr++) {
            memset(ug + (r * 2 + sr) * C * 2 + c * 2, 0, 2);
            memset(vg + (r * 2 + sr) * C * 2 + c * 2, 0, 2);
          }
          if (y2_coded[gmb]) {
            y2_above[g * C + c] = 0;
            y2_above_valid[g * C + c] = 1;
            y2_left[g] = 0;
            y2_left_valid[g] = 1;
          }
          continue;
        }
        live[g] = 1;
        if (y2_coded[gmb]) {
          const int ctx = (y2_above_valid[g * C + c] ? y2_above[g * C + c] : 0)
                          + (y2_left_valid[g] ? y2_left[g] : 0);
          /* Y2 is parsed FIRST but its dense index (block 24) sorts LAST
           * in the macroblock: buffer it and emit after chroma so the
           * compact stream's deltas stay strictly ascending */
          const uint32_t m = parse_block_mask(
              *bd_row[g],
              coeff_probs + ((size_t)g * 4 + 1) * 8 * 3 * 11,
              ctx, 0, y2_tmp + g * 16);
          const int nz = m != 0;
          y2_pend[g] = m;
          y2_above[g * C + c] = (uint8_t)nz;
          y2_above_valid[g * C + c] = 1;
          y2_left[g] = (uint8_t)nz;
          y2_left_valid[g] = 1;
          mb_nz[g] |= nz;
        } else {
          y2_pend[g] = 0;
        }
      }
      /* phase 1: 16 Y blocks, g-inner so chains interleave.
       * Per-(g, MB) constants (probs base, first index, dense element
       * base, nz-plane corner) hoist out of the 16-subblock loop. */
      {
        const uint8_t *probs_y[kMaxG];
        int first_y[kMaxG];
        int64_t ybase[kMaxG];   /* dense element index of Y block 0 */
        uint8_t *nzc[kMaxG];    /* nz-plane corner (gr0, gc0) */
        for (int g = g0; g < g1; g++) {
          if (!live[g]) continue;
          const int y2c = y2_coded[g * R * C + mb];
          probs_y[g] = coeff_probs + ((size_t)g * 4 + (y2c ? 0 : 3))
                       * 8 * 3 * 11;
          first_y[g] = y2c ? 1 : 0;
          ybase[g] = ((int64_t)g * R * C * 25 + (int64_t)mb * 25) * 16;
          nzc[g] = y_nz + (size_t)g * R * 4 * C * 4 + (size_t)(r * 4)
                   * C * 4 + c * 4;
        }
        const int stride = C * 4;
        for (int b = 0; b < 16; b++) {
          const int sr = b >> 2, sc = b & 3;
          const bool has_up = r > 0 || sr > 0;
          const bool has_left = c > 0 || sc > 0;
          for (int g = g0; g < g1; g++) {
            if (!live[g]) continue;
            uint8_t *cell = nzc[g] + sr * stride + sc;
            const int ctx = (has_up ? cell[-stride] : 0) +
                            (has_left ? cell[-1] : 0);
            int16_t tmp[16];
            const uint32_t m = parse_block_mask(
                *bd_row[g], probs_y[g], ctx, first_y[g], tmp);
            if (m) emit_block(g, ybase[g] + b * 16, tmp, m);
            *cell = (uint8_t)(m != 0);
            mb_nz[g] |= (int)m;
          }
        }
      }
      /* phase 2: 8 chroma blocks */
      for (int plane = 0; plane < 2; plane++) {
        uint8_t *nz_base = plane ? v_nz : u_nz;
        const int cbase = 16 + plane * 4;
        const int stride = C * 2;
        for (int b = 0; b < 4; b++) {
          const int sr = b >> 1, sc = b & 1;
          const bool has_up = r > 0 || sr > 0;
          const bool has_left = c > 0 || sc > 0;
          for (int g = g0; g < g1; g++) {
            if (!live[g]) continue;
            uint8_t *cell = nz_base + (size_t)g * R * 2 * C * 2
                            + (size_t)(r * 2 + sr) * stride + c * 2 + sc;
            const int ctx = (has_up ? cell[-stride] : 0) +
                            (has_left ? cell[-1] : 0);
            int16_t tmp[16];
            const uint32_t m = parse_block_mask(
                *bd_row[g],
                coeff_probs + ((size_t)g * 4 + 2) * 8 * 3 * 11,
                ctx, 0, tmp);
            if (m) emit_block(g, ((int64_t)g * R * C * 25
                                  + (int64_t)mb * 25
                                  + (cbase + b)) * 16, tmp, m);
            *cell = (uint8_t)(m != 0);
            mb_nz[g] |= (int)m;
          }
        }
      }
      for (int g = g0; g < g1; g++) {
        if (!live[g]) continue;
        if (y2_pend[g])
          emit_block(g, ((int64_t)g * R * C * 25 + (int64_t)mb * 25 + 24)
                     * 16, y2_tmp + g * 16, y2_pend[g]);
        has_nonzero_out[g * R * C + mb] = (uint8_t)(mb_nz[g] != 0);
      }
    }
  }
  delete[] y_nz;
  delete[] u_nz;
  delete[] v_nz;
  delete[] y2_above;
  delete[] y2_above_valid;
  for (int g = g0; g < g1; g++) {
    seg_count[g] = seg_pos[g] - seg_base[g];
    desc_count[g] = desc_pos_g[g] - esc_base[g];
    vesc_count[g] = vesc_pos_g[g] - esc_base[g];
    last_out[g] = last_idx[g];
  }
  return overflow;
}

int vp8_parse_tokens_gop(int G, int mb_rows, int mb_cols,
                         const uint8_t *data, const int64_t *offsets,
                         const int32_t *nparts, const int32_t *part_base,
                         const uint8_t *coeff_probs, const uint8_t *skip,
                         const uint8_t *y2_coded, uint8_t *has_nonzero_out,
                         uint8_t *sp_delta, int8_t *sp_val,
                         int32_t *desc_pos, int32_t *desc_extra,
                         int32_t *vesc_pos, int16_t *vesc_val,
                         int64_t *seg_meta) {
  if (G < 1 || G > kMaxG) return -1;
  for (int g = 0; g < G; g++)
    if (nparts[g] < 1 || nparts[g] > 8) return -1;
  return parse_tokens_range(0, G, G, mb_rows, mb_cols, data, offsets,
                            nparts, part_base, coeff_probs, skip, y2_coded,
                            has_nonzero_out, sp_delta, sp_val, desc_pos,
                            desc_extra, vesc_pos, vesc_val, seg_meta)
             ? -2 : 0;
}

/* Multithreaded token parse: the G independent streams are split into
 * `threads` contiguous ranges, one std::thread each.  The range decoder
 * is a serial dependency chain, so cores scale it where interleaving
 * cannot; outputs are bit-identical to vp8_parse_tokens_gop (disjoint
 * per-frame state).  Same return codes. */
int vp8_parse_tokens_gop_mt(int threads, int G, int mb_rows, int mb_cols,
                         const uint8_t *data, const int64_t *offsets,
                         const int32_t *nparts, const int32_t *part_base,
                         const uint8_t *coeff_probs, const uint8_t *skip,
                         const uint8_t *y2_coded, uint8_t *has_nonzero_out,
                         uint8_t *sp_delta, int8_t *sp_val,
                         int32_t *desc_pos, int32_t *desc_extra,
                         int32_t *vesc_pos, int16_t *vesc_val,
                         int64_t *seg_meta) {
  if (G < 1 || G > kMaxG) return -1;
  for (int g = 0; g < G; g++)
    if (nparts[g] < 1 || nparts[g] > 8) return -1;
  if (threads > G) threads = G;
  if (threads <= 1)
    return parse_tokens_range(0, G, G, mb_rows, mb_cols, data, offsets,
                              nparts, part_base, coeff_probs, skip, y2_coded,
                              has_nonzero_out, sp_delta, sp_val, desc_pos,
                              desc_extra, vesc_pos, vesc_val, seg_meta)
               ? -2 : 0;
  bool ov[kMaxG] = {};
  std::vector<std::thread> ts;
  ts.reserve(threads);
  for (int t = 0; t < threads; t++) {
    const int lo = G * t / threads, hi = G * (t + 1) / threads;
    if (lo == hi) continue;
    ts.emplace_back([=, &ov]() {
      ov[t] = parse_tokens_range(lo, hi, G, mb_rows, mb_cols, data, offsets,
                                 nparts, part_base, coeff_probs, skip,
                                 y2_coded, has_nonzero_out, sp_delta, sp_val,
                                 desc_pos, desc_extra, vesc_pos, vesc_val,
                                 seg_meta);
    });
  }
  for (auto &th : ts) th.join();
  for (int t = 0; t < threads; t++)
    if (ov[t]) return -2;
  return 0;
}

/* Async token parse: start returns immediately with the worker threads
 * running (the Python caller overlaps its frame-packing numpy work with
 * the bit-serial decode), join blocks until done and returns the same
 * codes as vp8_parse_tokens_gop_mt.  All pointer arguments must stay
 * valid until join returns. */
struct GopTokenJob {
  std::vector<std::thread> ts;
  bool ov[kMaxG];
};

void *vp8_parse_tokens_gop_mt_start(
                         int threads, int G, int mb_rows, int mb_cols,
                         const uint8_t *data, const int64_t *offsets,
                         const int32_t *nparts, const int32_t *part_base,
                         const uint8_t *coeff_probs, const uint8_t *skip,
                         const uint8_t *y2_coded, uint8_t *has_nonzero_out,
                         uint8_t *sp_delta, int8_t *sp_val,
                         int32_t *desc_pos, int32_t *desc_extra,
                         int32_t *vesc_pos, int16_t *vesc_val,
                         int64_t *seg_meta) {
  if (G < 1 || G > kMaxG) return nullptr;
  for (int g = 0; g < G; g++)
    if (nparts[g] < 1 || nparts[g] > 8) return nullptr;
  if (threads > G) threads = G;
  if (threads < 1) threads = 1;
  GopTokenJob *job = new GopTokenJob();
  std::memset(job->ov, 0, sizeof job->ov);
  bool *ov = job->ov;
  job->ts.reserve(threads);
  for (int t = 0; t < threads; t++) {
    const int lo = G * t / threads, hi = G * (t + 1) / threads;
    if (lo == hi) continue;
    job->ts.emplace_back([=]() {
      ov[t] = parse_tokens_range(lo, hi, G, mb_rows, mb_cols, data, offsets,
                                 nparts, part_base, coeff_probs, skip,
                                 y2_coded, has_nonzero_out, sp_delta, sp_val,
                                 desc_pos, desc_extra, vesc_pos, vesc_val,
                                 seg_meta);
    });
  }
  return job;
}

int vp8_parse_tokens_gop_mt_join(void *p) {
  GopTokenJob *job = (GopTokenJob *)p;
  for (auto &th : job->ts) th.join();
  int rc = 0;
  for (int t = 0; t < kMaxG; t++)
    if (job->ov[t]) rc = -2;
  delete job;
  return rc;
}

/* Header fast path: a run of N "Flagged<Unsigned<width>>" elements, the
 * dominant cost of VP8 frame-header parsing (TokenProbUpdate[4][8][3][11]
 * = 1056 flags; MVProbUpdate[2][19]; frame_header.hh:194-325).  The caller
 * passes the Python BoolDecoder state in/out as int64[4] =
 * {pos, range, value, bit_count}. */
int vp8_parse_flagged_literals(const uint8_t *data, int64_t size,
                               int64_t *state, int n, int width,
                               const uint8_t *update_probs,
                               uint8_t *flags_out, uint8_t *vals_out) {
  BoolDecoder bd;
  bd.data = data;
  bd.size = size;
  bd.pos = state[0];
  bd.range_ = (uint32_t)state[1];
  bd.value = (uint32_t)state[2];
  bd.bit_count = (int)state[3];
  for (int i = 0; i < n; i++) {
    if (bd.get(update_probs[i])) {
      int v = 0;
      for (int b = 0; b < width; b++) v = (v << 1) | bd.get(128);
      flags_out[i] = 1;
      vals_out[i] = (uint8_t)v;
    } else {
      flags_out[i] = 0;
    }
  }
  state[0] = bd.pos;
  state[1] = bd.range_;
  state[2] = bd.value;
  state[3] = bd.bit_count;
  return 0;
}

/* Whole frame-header scalar parse (KeyFrameHeader.parse /
 * InterFrameHeader.parse grammar, bitstream/header.py; reference
 * decoder/frame_header.hh:37-325).  Fills a flat i32 record (INT32_MIN =
 * absent optional) plus the token/mv prob-update flag+value runs; leaves
 * the decoder state in state[4] = {pos, range, value, bit_count} so the
 * Python BoolDecoder resumes at the MB headers.
 *
 * out[] layout:
 *   0 has_update_segmentation  1 update_mb_segmentation_map
 *   2 has_segment_feature_data 3 segment_feature_mode
 *   4..7 quantizer_update[4]   8..11 loop_filter_update[4]
 *   12..14 mb_segmentation_map probs[3]
 *   15 filter_type  16 loop_filter_level  17 sharpness_level
 *   18 mode_lf_adjustments_enabled  19 has_mode_lf_update
 *   20..23 ref_update[4]  24..27 mode_update[4]
 *   28 log2_number_of_dct_partitions
 *   29 y_ac_qi  30..34 y_dc,y2_dc,y2_ac,uv_dc,uv_ac
 *   35 refresh_entropy_probs  36 prob_skip_false
 *   interframe only:
 *   37 refresh_golden  38 refresh_alternate  39 copy_to_golden
 *   40 copy_to_alternate  41 sign_bias_golden  42 sign_bias_alternate
 *   43 refresh_last  44 prob_inter  45 prob_references_last
 *   46 prob_references_golden  47 has_intra_16x16  48..51 y probs
 *   52 has_intra_chroma  53..55 uv probs
 *   keyframe only: 56 color_space  57 clamping_type
 * Returns 0 ok, -3 unsupported stream feature (caller falls back to the
 * Python parser, which raises the precise error). */
int vp8_parse_frame_header(const uint8_t *data, int64_t size, int key_frame,
                           int32_t *out, const uint8_t *tok_up,
                           uint8_t *tok_flags, uint8_t *tok_vals,
                           const uint8_t *mv_up, uint8_t *mv_flags,
                           uint8_t *mv_vals, int64_t *state) {
  BoolDecoder bd;
  bd.init(data, size);
  const int32_t SENT = INT32_MIN;
  for (int i = 0; i < 64; i++) out[i] = SENT;
  auto uns = [&](int w) {
    int v = 0;
    for (int b = 0; b < w; b++) v = (v << 1) | bd.get(128);
    return v;
  };
  auto sgn = [&](int w) {
    int v = uns(w);
    return bd.get(128) ? -v : v;
  };
  auto flag_u = [&](int w) { return bd.get(128) ? (int32_t)uns(w) : SENT; };
  auto flag_s = [&](int w) { return bd.get(128) ? (int32_t)sgn(w) : SENT; };

  if (key_frame) {
    out[56] = bd.get(128);
    out[57] = bd.get(128);
    if (out[56] || out[57]) return -3;   /* color_space / clamping_type */
  }
  const int has_seg = bd.get(128);
  out[0] = has_seg;
  if (has_seg) {
    out[1] = bd.get(128);
    const int has_fd = bd.get(128);
    out[2] = has_fd;
    if (has_fd) {
      out[3] = bd.get(128);
      for (int i = 0; i < 4; i++) out[4 + i] = flag_s(7);
      for (int i = 0; i < 4; i++) out[8 + i] = flag_s(6);
    }
    if (out[1])
      for (int i = 0; i < 3; i++) out[12 + i] = flag_u(8);
  }
  out[15] = bd.get(128);
  if (out[15]) return -3;                /* 'simple' loop filter */
  out[16] = uns(6);
  out[17] = uns(3);
  out[18] = bd.get(128);
  out[19] = 0;
  if (out[18]) {
    out[19] = bd.get(128);
    if (out[19]) {
      for (int i = 0; i < 4; i++) out[20 + i] = flag_s(6);
      for (int i = 0; i < 4; i++) out[24 + i] = flag_s(6);
    }
  }
  out[28] = uns(2);
  out[29] = uns(7);
  for (int i = 0; i < 5; i++) out[30 + i] = flag_s(4);
  if (!key_frame) {
    out[37] = bd.get(128);
    out[38] = bd.get(128);
    if (!out[37]) out[39] = uns(2);
    if (!out[38]) out[40] = uns(2);
    out[41] = bd.get(128);
    out[42] = bd.get(128);
    out[35] = bd.get(128);
    out[43] = bd.get(128);
  } else {
    out[35] = bd.get(128);
  }
  for (int i = 0; i < 1056; i++) {
    if (bd.get(tok_up[i])) {
      int v = 0;
      for (int b = 0; b < 8; b++) v = (v << 1) | bd.get(128);
      tok_flags[i] = 1;
      tok_vals[i] = (uint8_t)v;
    } else {
      tok_flags[i] = 0;
    }
  }
  out[36] = flag_u(8);
  if (!key_frame) {
    out[44] = uns(8);
    out[45] = uns(8);
    out[46] = uns(8);
    out[47] = bd.get(128);
    if (out[47])
      for (int i = 0; i < 4; i++) out[48 + i] = uns(8);
    out[52] = bd.get(128);
    if (out[52])
      for (int i = 0; i < 3; i++) out[53 + i] = uns(8);
    for (int i = 0; i < 38; i++) {
      if (bd.get(mv_up[i])) {
        mv_flags[i] = 1;
        mv_vals[i] = (uint8_t)uns(7);
      } else {
        mv_flags[i] = 0;
      }
    }
  }
  state[0] = bd.pos;
  state[1] = bd.range_;
  state[2] = bd.value;
  state[3] = bd.bit_count;
  return 0;
}

/* ---- token serialization (serializer.cc:388-426, 596-737) ---- */

} // extern "C" — C++ helpers below

namespace {

/* Mirror of the Python BoolEncoder (bitstream/boolcoder.py; reference
 * encoder/bool_encoder.hh:60-152): carry-propagating range encoder with
 * the libvpx-compatible flush. */
struct BoolEnc {
  uint8_t *out;
  int64_t len, cap;
  uint32_t range_;
  uint64_t bottom;
  int bit_count;
  bool overflow;

  void init(uint8_t *buf, int64_t capacity) {
    out = buf;
    len = 0;
    cap = capacity;
    range_ = 255;
    bottom = 0;
    bit_count = -24;
    overflow = false;
  }

  inline void put(int value, int probability) {
    const uint32_t split = 1 + (((range_ - 1) * (uint32_t)probability) >> 8);
    if (value) {
      bottom += split;
      range_ -= split;
    } else {
      range_ = split;
    }
    int shift = kNormTable.v[range_];
    range_ <<= shift;
    bit_count += shift;
    if (bit_count >= 0) {
      const int offset = shift - bit_count;
      if ((bottom << (offset - 1)) & 0x80000000ULL) {
        int64_t i = len - 1;
        while (out[i] == 255) out[i--] = 0;
        out[i] += 1;
      }
      if (len < cap) out[len++] = (bottom >> (24 - offset)) & 0xFF;
      else overflow = true;
      bottom = (bottom << offset) & 0xFFFFFF;
      shift = bit_count;
      bit_count -= 8;
    }
    bottom = (bottom << shift) & 0xFFFFFFFFULL;
  }

  void finish() {
    for (int i = 0; i < 32; i++) put(0, 128);
  }
};

inline void write_extra(BoolEnc &be, int value, int cat) {
  const TokenExtra &te = kExtra[cat];
  const int inc = value - te.base;
  for (int i = 0; i < te.nbits; i++) {
    be.put((inc >> (te.nbits - 1 - i)) & 1, te.probs[i]);
  }
}

/* write_block_tokens (serializer.cc:596-737); returns has_nonzero over
 * raster positions >= first. */
inline int write_block(BoolEnc &be, const int16_t *co,
                       const uint8_t *coeff_probs, int block_type, int ctx,
                       int first) {
  const uint8_t *probs_bt = coeff_probs + block_type * 8 * 3 * 11;
  int coded_length = 0;
  for (int index = first; index < 16; index++) {
    if (co[kZigzag[index]]) coded_length = index + 1;
  }
  bool last_was_zero = false;
  int token_context = ctx;
  int index = first;
  int has_nonzero = 0;
  while (index < coded_length) {
    const int coefficient = co[kZigzag[index]];
    const int v = coefficient < 0 ? -coefficient : coefficient;
    const int sign = coefficient < 0;
    const uint8_t *prob = probs_bt + (kBand[index] * 3 + token_context) * 11;
    if (!last_was_zero) be.put(1, prob[0]);
    if (v == 0) {
      be.put(0, prob[1]);
      last_was_zero = true;
      token_context = 0;
      index++;
      continue;
    }
    last_was_zero = false;
    has_nonzero = 1;
    be.put(1, prob[1]);
    if (v == 1) {
      be.put(0, prob[2]);
      be.put(sign, 128);
      token_context = 1;
      index++;
      continue;
    }
    token_context = 2;
    be.put(1, prob[2]);
    if (v == 2) {
      be.put(0, prob[3]);
      be.put(0, prob[4]);
    } else if (v == 3) {
      be.put(0, prob[3]);
      be.put(1, prob[4]);
      be.put(0, prob[5]);
    } else if (v == 4) {
      be.put(0, prob[3]);
      be.put(1, prob[4]);
      be.put(1, prob[5]);
    } else {
      be.put(1, prob[3]);
      if (v < 7) {
        be.put(0, prob[6]);
        be.put(0, prob[7]);
        be.put(v == 6, 159);
      } else if (v < 11) {
        be.put(0, prob[6]);
        be.put(1, prob[7]);
        write_extra(be, v, 0);
      } else {
        be.put(1, prob[6]);
        if (v < 19) {
          be.put(0, prob[8]);
          be.put(0, prob[9]);
          write_extra(be, v, 1);
        } else if (v < 35) {
          be.put(0, prob[8]);
          be.put(1, prob[9]);
          write_extra(be, v, 2);
        } else if (v < 67) {
          be.put(1, prob[8]);
          be.put(0, prob[10]);
          write_extra(be, v, 3);
        } else {
          be.put(1, prob[8]);
          be.put(1, prob[10]);
          write_extra(be, v, 4);
        }
      }
    }
    be.put(sign, 128);
    index++;
  }
  if (coded_length < 16) {
    const uint8_t *prob = probs_bt + (kBand[index] * 3 + token_context) * 11;
    be.put(0, prob[0]);
  }
  return has_nonzero;
}

/* accumulate_token_branches for one block (serializer.cc:456-594) */
inline void count_block(int64_t *counts, const int16_t *co, int bt, int ctx,
                        int first) {
  int coded_length = 0;
  for (int index = first; index < 16; index++) {
    if (co[kZigzag[index]]) coded_length = index + 1;
  }
  bool last_was_zero = false;
  int token_context = ctx;
  int index = first;
  while (index < coded_length) {
    int v = co[kZigzag[index]];
    if (v < 0) v = -v;
    int64_t *node = counts + (((bt * 8 + kBand[index]) * 3
                               + token_context) * 11) * 2;
    if (!last_was_zero) node[0 * 2 + 1]++;
    if (v == 0) {
      node[1 * 2 + 0]++;
      last_was_zero = true;
      token_context = 0;
      index++;
      continue;
    }
    last_was_zero = false;
    node[1 * 2 + 1]++;
    if (v == 1) {
      node[2 * 2 + 0]++;
      token_context = 1;
    } else {
      node[2 * 2 + 1]++;
      token_context = 2;
      if (v <= 4) {
        node[3 * 2 + 0]++;
        if (v == 2) {
          node[4 * 2 + 0]++;
        } else {
          node[4 * 2 + 1]++;
          node[5 * 2 + (v == 3 ? 0 : 1)]++;
        }
      } else {
        node[3 * 2 + 1]++;
        if (v < 11) {
          node[6 * 2 + 0]++;
          node[7 * 2 + (v < 7 ? 0 : 1)]++;
        } else {
          node[6 * 2 + 1]++;
          if (v < 35) {
            node[8 * 2 + 0]++;
            node[9 * 2 + (v < 19 ? 0 : 1)]++;
          } else {
            node[8 * 2 + 1]++;
            node[10 * 2 + (v < 67 ? 0 : 1)]++;
          }
        }
      }
    }
    index++;
  }
  if (coded_length < 16) {
    counts[(((bt * 8 + kBand[index]) * 3 + token_context) * 11 + 0) * 2
           + 0]++;
  }
}

inline int any16(const int16_t *co, int first) {
  for (int i = first; i < 16; i++)
    if (co[i]) return 1;
  return 0;
}

/* Shared frame walk in coding order with the exact cross-MB nonzero
 * contexts (serializer.py iter_frame_blocks; frame.cc:121-137).  mode 0:
 * serialize into per-partition encoders; mode 1: count branches. */
template <typename Fn>
void walk_frame_blocks(const int16_t *coeffs, const uint8_t *skip,
                       const uint8_t *y2_coded, int R, int C, Fn &&emit) {
  uint8_t *y_nz = new uint8_t[R * 4 * C * 4]();
  uint8_t *u_nz = new uint8_t[R * 2 * C * 2]();
  uint8_t *v_nz = new uint8_t[R * 2 * C * 2]();
  uint8_t *y2_above = new uint8_t[C]();
  uint8_t *y2_above_valid = new uint8_t[C]();

  for (int r = 0; r < R; r++) {
    uint8_t y2_left = 0, y2_left_valid = 0;
    for (int c = 0; c < C; c++) {
      const int mb = r * C + c;
      const int16_t *mbc = coeffs + (int64_t)mb * 25 * 16;
      if (skip[mb]) {
        for (int sr = 0; sr < 4; sr++)
          memset(y_nz + (r * 4 + sr) * C * 4 + c * 4, 0, 4);
        for (int sr = 0; sr < 2; sr++) {
          memset(u_nz + (r * 2 + sr) * C * 2 + c * 2, 0, 2);
          memset(v_nz + (r * 2 + sr) * C * 2 + c * 2, 0, 2);
        }
        if (y2_coded[mb]) {
          y2_above[c] = 0;
          y2_above_valid[c] = 1;
          y2_left = 0;
          y2_left_valid = 1;
        }
        continue;
      }
      if (y2_coded[mb]) {
        const int ctx = (y2_above_valid[c] ? y2_above[c] : 0) +
                        (y2_left_valid ? y2_left : 0);
        emit(r, mbc + 24 * 16, 1 /*Y2*/, ctx, 0);
        const int nz = any16(mbc + 24 * 16, 0);
        y2_above[c] = nz;
        y2_above_valid[c] = 1;
        y2_left = nz;
        y2_left_valid = 1;
      }
      const int bt = y2_coded[mb] ? 0 : 3;
      const int first = y2_coded[mb] ? 1 : 0;
      for (int sr = 0; sr < 4; sr++) {
        for (int sc = 0; sc < 4; sc++) {
          const int gr = r * 4 + sr, gc = c * 4 + sc;
          const int ctx = (gr > 0 ? y_nz[(gr - 1) * C * 4 + gc] : 0) +
                          (gc > 0 ? y_nz[gr * C * 4 + gc - 1] : 0);
          const int16_t *co = mbc + (sr * 4 + sc) * 16;
          emit(r, co, bt, ctx, first);
          y_nz[gr * C * 4 + gc] = any16(co, first);
        }
      }
      uint8_t *planes[2] = {u_nz, v_nz};
      for (int plane = 0; plane < 2; plane++) {
        uint8_t *nzp = planes[plane];
        const int base = 16 + plane * 4;
        for (int sr = 0; sr < 2; sr++) {
          for (int sc = 0; sc < 2; sc++) {
            const int gr = r * 2 + sr, gc = c * 2 + sc;
            const int ctx = (gr > 0 ? nzp[(gr - 1) * C * 2 + gc] : 0) +
                            (gc > 0 ? nzp[gr * C * 2 + gc - 1] : 0);
            const int16_t *co = mbc + (base + sr * 2 + sc) * 16;
            emit(r, co, 2 /*UV*/, ctx, 0);
            nzp[gr * C * 2 + gc] = any16(co, 0);
          }
        }
      }
    }
  }
  delete[] y_nz;
  delete[] u_nz;
  delete[] v_nz;
  delete[] y2_above;
  delete[] y2_above_valid;
}

} // namespace

extern "C" {

/* Serialize the DCT token partitions.  out: n_parts buffers of out_cap
 * bytes each (contiguous); out_lens[n_parts] receives the lengths.
 * Returns 0, or -2 if a partition overflowed out_cap. */
int vp8_serialize_tokens(const int16_t *coeffs, const uint8_t *skip,
                         const uint8_t *y2_coded, int R, int C,
                         const uint8_t *coeff_probs, int n_parts,
                         uint8_t *out, int64_t out_cap, int64_t *out_lens) {
  BoolEnc encs[8];
  if (n_parts < 1 || n_parts > 8) return -1;
  for (int i = 0; i < n_parts; i++) encs[i].init(out + i * out_cap, out_cap);
  walk_frame_blocks(coeffs, skip, y2_coded, R, C,
                    [&](int r, const int16_t *co, int bt, int ctx,
                        int first) {
                      write_block(encs[r % n_parts], co, coeff_probs, bt,
                                  ctx, first);
                    });
  int rc = 0;
  for (int i = 0; i < n_parts; i++) {
    encs[i].finish();
    out_lens[i] = encs[i].len;
    if (encs[i].overflow) rc = -2;
  }
  return rc;
}

/* Keyframe MB headers: optional skip flag + KF mode trees for every MB
 * (serializer.cc:165-230 keyframe side), resuming a Python BoolEncoder.
 * state: i64[3] = {range, bottom, bit_count}; buf holds the bytes written
 * so far (carry propagation may rewrite them); len_io[0] is the length.
 * Tree paths arrive as (bits, prob_idx, len) tables with stride 8. */
int vp8_write_kf_modes(int64_t *state, uint8_t *buf, int64_t cap,
                       int64_t *len_io, int R, int C,
                       const int8_t *ymode, const int8_t *bmode,
                       const int8_t *uvmode, const uint8_t *skip,
                       int has_skip, int prob_skip,
                       const uint8_t *yp_bits, const uint8_t *yp_idx,
                       const uint8_t *yp_len, const uint8_t *yprobs,
                       const uint8_t *bp_bits, const uint8_t *bp_idx,
                       const uint8_t *bp_len, const uint8_t *kfb_probs,
                       const uint8_t *up_bits, const uint8_t *up_idx,
                       const uint8_t *up_len, const uint8_t *uvprobs) {
  BoolEnc be;
  be.out = buf;
  be.len = *len_io;
  be.cap = cap;
  be.range_ = (uint32_t)state[0];
  be.bottom = (uint64_t)state[1];
  be.bit_count = (int)state[2];
  be.overflow = false;

  auto wtree = [&](const uint8_t *bits, const uint8_t *idx,
                   const uint8_t *lens, const uint8_t *probs, int leaf) {
    const int n = lens[leaf];
    for (int k = 0; k < n; k++) {
      be.put(bits[leaf * 8 + k], probs[idx[leaf * 8 + k]]);
    }
  };

  for (int r = 0; r < R; r++) {
    for (int c = 0; c < C; c++) {
      const int mb = r * C + c;
      if (has_skip) be.put(skip[mb] != 0, prob_skip);
      const int ym = ymode[mb];
      wtree(yp_bits, yp_idx, yp_len, yprobs, ym);
      if (ym == 4 /* B_PRED */) {
        const int8_t *bm = bmode + (int64_t)mb * 16;
        for (int sr = 0; sr < 4; sr++) {
          for (int sc = 0; sc < 4; sc++) {
            int above, left;
            if (sr > 0) above = bm[(sr - 1) * 4 + sc];
            else if (r > 0) above = bmode[((int64_t)(mb - C)) * 16 + 12 + sc];
            else above = 0;
            if (sc > 0) left = bm[sr * 4 + sc - 1];
            else if (c > 0) left = bmode[((int64_t)(mb - 1)) * 16 + sr * 4 + 3];
            else left = 0;
            wtree(bp_bits, bp_idx, bp_len,
                  kfb_probs + (above * 10 + left) * 9, bm[sr * 4 + sc]);
          }
        }
      }
      wtree(up_bits, up_idx, up_len, uvprobs, uvmode[mb]);
    }
  }
  state[0] = be.range_;
  state[1] = (int64_t)be.bottom;
  state[2] = be.bit_count;
  *len_io = be.len;
  return be.overflow ? -2 : 0;
}

/* Flagged-literal runs in frame headers (token/mv prob updates): for each
 * position, a flag bit against probs[i], then a `bits`-wide literal when
 * the flag is set.  Write-side twin of vp8_parse_flagged_literals,
 * resuming a Python BoolEncoder (state i64[3] = {range, bottom,
 * bit_count}). */
int vp8_write_flagged_literals(int64_t *state, uint8_t *buf, int64_t cap,
                               int64_t *len_io, const uint8_t *probs,
                               const uint8_t *flags, const uint8_t *vals,
                               int64_t n, int bits) {
  BoolEnc be;
  be.out = buf;
  be.len = *len_io;
  be.cap = cap;
  be.range_ = (uint32_t)state[0];
  be.bottom = (uint64_t)state[1];
  be.bit_count = (int)state[2];
  be.overflow = false;
  for (int64_t i = 0; i < n; i++) {
    be.put(flags[i] != 0, probs[i]);
    if (flags[i]) {
      for (int k = bits - 1; k >= 0; k--) be.put((vals[i] >> k) & 1, 128);
    }
  }
  state[0] = be.range_;
  state[1] = (int64_t)be.bottom;
  state[2] = be.bit_count;
  *len_io = be.len;
  return be.overflow ? -2 : 0;
}

/* Interframe MB headers (serializer.cc:165-316 inter side), resuming a
 * Python BoolEncoder exactly like vp8_write_kf_modes.
 *
 * trees: packed path-table arena, 8 trees x 272 bytes each in the order
 *   [mv_ref, submv_ref, split_mv, small_mv, y, bmode, uv, segment_id];
 *   per tree: bits u8[16][8] @0, prob_idx u8[16][8] @128, len u8[16] @256.
 * mvpart_n / mvpart_first: per SPLITMV scheme, the partition count and the
 *   (sr, sc) of each partition's first subblock (u8[4], u8[4][16][2]).
 */
static inline void wtree_arena(BoolEnc &be, const uint8_t *trees, int t,
                               const uint8_t *probs, int leaf) {
  const uint8_t *base = trees + t * 272;
  const int n = base[256 + leaf];
  for (int k = 0; k < n; k++)
    be.put(base[leaf * 8 + k], probs[base[128 + leaf * 8 + k]]);
}

/* One MV component (serializer.cc:197-236); probs: 19 per component. */
static inline void write_mv_component(BoolEnc &be, int num,
                                      const uint8_t *probs,
                                      const uint8_t *trees) {
  const int nte = num >> 1; /* arithmetic shift, same as Python's >> */
  const int x = nte < 0 ? -nte : nte;
  if (x < 8) {
    be.put(0, probs[0]);
    wtree_arena(be, trees, 3 /*small_mv*/, probs + 2, x);
  } else {
    be.put(1, probs[0]);
    for (int i = 0; i < 3; i++) be.put((x >> i) & 1, probs[9 + i]);
    for (int i = 9; i > 3; i--) be.put((x >> i) & 1, probs[9 + i]);
    if (x & 0xFFF0) be.put((x >> 3) & 1, probs[9 + 3]);
  }
  if (x) be.put(nte < 0 ? 1 : 0, probs[1]);
}

static inline void write_mv2(BoolEnc &be, int dx, int dy,
                             const uint8_t *mv_probs, const uint8_t *trees) {
  write_mv_component(be, dy, mv_probs, trees);      /* y first */
  write_mv_component(be, dx, mv_probs + 19, trees);
}

/* Scorer census over above/left/above-left (decoder/parse.py mv_census;
 * reference scorer.hh:36-79).  out: best xy, nearest xy, counts[4]. */
static void census_c(const int8_t *ref, const int16_t *sub_mv,
                     const int8_t *ymode, const uint8_t *flipped, int C,
                     int r, int c, int *best, int *counts) {
  int scores[4] = {0, 0, 0, 0};
  int mvx[4] = {0, 0, 0, 0}, mvy[4] = {0, 0, 0, 0};
  int splitmv_score = 0, index = 0;
  const int fl = flipped[r * C + c];
  const int poss[3][3] = {{2, r - 1, c}, {2, r, c - 1}, {1, r - 1, c - 1}};
  for (int i = 0; i < 3; i++) {
    const int score = poss[i][0], rr = poss[i][1], cc = poss[i][2];
    if (rr < 0 || cc < 0) continue;
    const int mb = rr * C + cc;
    if (ref[mb] == 0 /*CURRENT_FRAME*/) continue;
    int x = sub_mv[(int64_t)(mb * 16 + 15) * 2 + 0];
    int y = sub_mv[(int64_t)(mb * 16 + 15) * 2 + 1];
    if ((int)flipped[mb] != fl) { x = -x; y = -y; }
    if (x == 0 && y == 0) {
      scores[0] += score;
    } else {
      if (x != mvx[index] || y != mvy[index]) {
        index++;
        mvx[index] = x;
        mvy[index] = y;
      }
      scores[index] += score;
    }
    if (ymode[mb] == 9 /*SPLITMV*/) splitmv_score += score;
  }
  if (scores[3]) {
    if (mvx[index] == mvx[1] && mvy[index] == mvy[1]) scores[1] += scores[3];
  }
  if (scores[2] > scores[1]) {
    int t;
    t = scores[1]; scores[1] = scores[2]; scores[2] = t;
    t = mvx[1]; mvx[1] = mvx[2]; mvx[2] = t;
    t = mvy[1]; mvy[1] = mvy[2]; mvy[2] = t;
  }
  if (scores[1] >= scores[0]) { mvx[0] = mvx[1]; mvy[0] = mvy[1]; }
  best[0] = mvx[0];
  best[1] = mvy[0];
  counts[0] = scores[0];
  counts[1] = scores[1];
  counts[2] = scores[2];
  counts[3] = splitmv_score;
}

int vp8_write_inter_modes(
    int64_t *state, uint8_t *buf, int64_t cap, int64_t *len_io, int R, int C,
    const int8_t *ymode, const int8_t *bmode, const int8_t *uvmode,
    const uint8_t *skip, int has_skip, int prob_skip, const int8_t *ref,
    const int16_t *sub_mv, const uint8_t *flipped, const int8_t *splitmv_pid,
    const int8_t *seg_map, int has_seg, const uint8_t *seg_probs,
    int prob_inter, int prob_ref_last, int prob_ref_golden,
    const uint8_t *y_probs, const uint8_t *uv_probs, const uint8_t *b_probs,
    const uint8_t *mv_probs, const uint8_t *c2p, const uint8_t *submv_probs2,
    const uint8_t *split_probs, const uint8_t *trees, const uint8_t *mvpart_n,
    const uint8_t *mvpart_first) {
  BoolEnc be;
  be.out = buf;
  be.len = *len_io;
  be.cap = cap;
  be.range_ = (uint32_t)state[0];
  be.bottom = (uint64_t)state[1];
  be.bit_count = (int)state[2];
  be.overflow = false;

  for (int r = 0; r < R; r++) {
    for (int c = 0; c < C; c++) {
      const int mb = r * C + c;
      if (has_seg)
        wtree_arena(be, trees, 7 /*segment_id*/, seg_probs, seg_map[mb]);
      if (has_skip) be.put(skip[mb] != 0, prob_skip);
      const int rf = ref[mb];
      const int ym = ymode[mb];
      be.put(rf != 0, prob_inter);
      if (rf != 0) {
        be.put(rf != 1, prob_ref_last);
        if (rf != 1) be.put(rf == 3, prob_ref_golden);
        int best[2], counts[4];
        census_c(ref, sub_mv, ymode, flipped, C, r, c, best, counts);
        const uint8_t mv_ref_probs[4] = {
            c2p[counts[0] * 4 + 0], c2p[counts[1] * 4 + 1],
            c2p[counts[2] * 4 + 2], c2p[counts[3] * 4 + 3]};
        wtree_arena(be, trees, 0 /*mv_ref*/, mv_ref_probs, ym);
        if (ym == 8 /*NEWMV*/ || ym == 9 /*SPLITMV*/) {
          /* clamp best (macroblock.cc:176-195) */
          const int to_left = -(c * 16 << 3) - 128;
          const int to_right = ((C - 1 - c) * 16 << 3) + 128;
          const int to_top = -(r * 16 << 3) - 128;
          const int to_bottom = ((R - 1 - r) * 16 << 3) + 128;
          int bx = best[0] < to_left ? to_left : best[0];
          if (bx > to_right) bx = to_right;
          int by = best[1] < to_top ? to_top : best[1];
          if (by > to_bottom) by = to_bottom;
          const int16_t *smv = sub_mv + (int64_t)mb * 16 * 2;
          if (ym == 8) {
            write_mv2(be, smv[15 * 2 + 0] - bx, smv[15 * 2 + 1] - by,
                      mv_probs, trees);
          } else {
            const int pid = splitmv_pid[mb];
            wtree_arena(be, trees, 2 /*split_mv*/, split_probs, pid);
            const int np = mvpart_n[pid];
            for (int p = 0; p < np; p++) {
              const int sr = mvpart_first[(pid * 16 + p) * 2 + 0];
              const int sc = mvpart_first[(pid * 16 + p) * 2 + 1];
              /* neighbor sub-MVs (serializer.cc:249-316) */
              int lx = 0, ly = 0, ax = 0, ay = 0;
              if (sc > 0) {
                lx = smv[(sr * 4 + sc - 1) * 2 + 0];
                ly = smv[(sr * 4 + sc - 1) * 2 + 1];
              } else if (c > 0) {
                const int16_t *n2 = sub_mv + (int64_t)(mb - 1) * 16 * 2;
                lx = n2[(sr * 4 + 3) * 2 + 0];
                ly = n2[(sr * 4 + 3) * 2 + 1];
              }
              if (sr > 0) {
                ax = smv[((sr - 1) * 4 + sc) * 2 + 0];
                ay = smv[((sr - 1) * 4 + sc) * 2 + 1];
              } else if (r > 0) {
                const int16_t *n2 = sub_mv + (int64_t)(mb - C) * 16 * 2;
                ax = n2[(12 + sc) * 2 + 0];
                ay = n2[(12 + sc) * 2 + 1];
              }
              const bool lz = (lx == 0 && ly == 0);
              const bool az = (ax == 0 && ay == 0);
              const bool eq = (lx == ax && ly == ay);
              int ctx;
              if (eq && lz) ctx = 4;
              else if (eq) ctx = 3;
              else if (az) ctx = 2;
              else if (lz) ctx = 1;
              else ctx = 0;
              const int sm = bmode[(int64_t)mb * 16 + sr * 4 + sc];
              wtree_arena(be, trees, 1 /*submv_ref*/, submv_probs2 + ctx * 3,
                          sm);
              if (sm == 13 /*NEW4X4*/) {
                write_mv2(be, smv[(sr * 4 + sc) * 2 + 0] - bx,
                          smv[(sr * 4 + sc) * 2 + 1] - by, mv_probs, trees);
              }
            }
          }
        }
      } else {
        /* intra MB inside an interframe (serializer.cc:227-237 analogue) */
        wtree_arena(be, trees, 4 /*y*/, y_probs, ym);
        if (ym == 4 /*B_PRED*/) {
          const int8_t *bm = bmode + (int64_t)mb * 16;
          for (int i = 0; i < 16; i++)
            wtree_arena(be, trees, 5 /*bmode*/, b_probs, bm[i]);
        }
        wtree_arena(be, trees, 6 /*uv*/, uv_probs, uvmode[mb]);
      }
    }
  }
  state[0] = be.range_;
  state[1] = (int64_t)be.bottom;
  state[2] = be.bit_count;
  *len_io = be.len;
  return be.overflow ? -2 : 0;
}

/* accumulate_token_branches over the frame; counts: i64[4][8][3][11][2]. */
int vp8_count_token_branches(const int16_t *coeffs, const uint8_t *skip,
                             const uint8_t *y2_coded, int R, int C,
                             int64_t *counts) {
  walk_frame_blocks(coeffs, skip, y2_coded, R, C,
                    [&](int r, const int16_t *co, int bt, int ctx,
                        int first) {
                      (void)r;
                      /* the reference accumulates Y/U/V only -- never Y2
                         (serializer.cc:583-587), so Y2 probs are never
                         updated; match it for size parity */
                      if (bt == 1) return;
                      count_block(counts, co, bt, ctx, first);
                    });
  return 0;
}

uint64_t vp8_hash_range(uint64_t seed, const uint64_t *values, int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    seed ^= values[i] + 0x9e3779b9ULL + (seed << 6) + (seed >> 2);
  }
  return seed;
}

/* byte-array fast path: hashes uint8 values directly */
uint64_t vp8_hash_bytes(uint64_t seed, const uint8_t *values, int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    seed ^= (uint64_t)values[i] + 0x9e3779b9ULL + (seed << 6) + (seed >> 2);
  }
  return seed;
}

} // extern "C"
