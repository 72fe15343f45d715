"""ctypes loader for the native bitwork library (auto-built on first use).

This copy binds the parse half (frame-header, MB-header and token
parsers, the state hashes) and the serializer half (token partitions,
key-frame and interframe MB headers, flagged-literal runs, token-branch
counts), and the AVX-512 8-lane token engine (tokensimd.cc), which a GOP
token parse takes by its ``engine`` argument."""
import ctypes
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "bitwork.cc")

_lib = None

# the GOP token-parse engines: "scalar" (bitwork.cc's interleaved loop,
# one OS thread per stream group), "simd" (tokensimd.cc's 8-lane AVX-512
# engine), "auto" (scalar on hosts with more than 2 cores, where the
# scalar fan-out over the G chains wins; on 1-2 cores the runtime
# calibration in parse_tokens_gop picks per (G, R, C))
ENGINES = ("auto", "scalar", "simd")
# per-(G, R, C) calibration samples of the "auto" choice on 1-2 cores
_ENGINE_CALIB = {}
# GOP token parses each engine ran to the end (the SIMD engine's -1, for
# inputs it does not take, lands in "scalar"): read by chip_smoke.py
engine_calls = {"scalar": 0, "simd": 0}


def _load():
    global _lib
    if _lib is not None:
        return _lib
    from alfalfa_tpu_torch.native._build import load_library
    lib = load_library(_SRC)
    lib.vp8_parse_tokens.restype = ctypes.c_int
    lib.vp8_parse_tokens.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.vp8_parse_tokens_mt.restype = ctypes.c_int
    lib.vp8_parse_tokens_mt.argtypes = [ctypes.c_int] + \
        lib.vp8_parse_tokens.argtypes
    lib.vp8_parse_tokens_gop.restype = ctypes.c_int
    lib.vp8_parse_tokens_gop.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
        + [ctypes.c_void_p] * 4 + [ctypes.c_void_p] * 7)
    lib.vp8_parse_tokens_gop_mt.restype = ctypes.c_int
    lib.vp8_parse_tokens_gop_mt.argtypes = (
        [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
        + [ctypes.c_void_p] * 4 + [ctypes.c_void_p] * 7)
    lib.vp8_parse_tokens_gop_mt_start.restype = ctypes.c_void_p
    lib.vp8_parse_tokens_gop_mt_start.argtypes = (
        [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
        + [ctypes.c_void_p] * 4 + [ctypes.c_void_p] * 7)
    lib.vp8_parse_tokens_gop_mt_join.restype = ctypes.c_int
    lib.vp8_parse_tokens_gop_mt_join.argtypes = [ctypes.c_void_p]
    lib.vp8_parse_flagged_literals.restype = ctypes.c_int
    lib.vp8_parse_flagged_literals.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.vp8_parse_frame_header.restype = ctypes.c_int
    lib.vp8_parse_frame_header.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int] + \
        [ctypes.c_void_p] * 8
    lib.vp8_serialize_tokens.restype = ctypes.c_int
    lib.vp8_serialize_tokens.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_void_p]
    lib.vp8_write_kf_modes.restype = ctypes.c_int
    lib.vp8_write_kf_modes.argtypes = (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 12)
    lib.vp8_write_flagged_literals.restype = ctypes.c_int
    lib.vp8_write_flagged_literals.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int]
    lib.vp8_write_inter_modes.restype = ctypes.c_int
    lib.vp8_write_inter_modes.argtypes = (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 4
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        + [ctypes.c_int] * 3
        + [ctypes.c_void_p] * 10)
    lib.vp8_count_token_branches.restype = ctypes.c_int
    lib.vp8_count_token_branches.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.vp8_hash_range.restype = ctypes.c_uint64
    lib.vp8_hash_range.argtypes = [ctypes.c_uint64, ctypes.c_void_p,
                                   ctypes.c_int64]
    lib.vp8_hash_bytes.restype = ctypes.c_uint64
    lib.vp8_hash_bytes.argtypes = [ctypes.c_uint64, ctypes.c_void_p,
                                   ctypes.c_int64]
    _lib = lib
    return lib


def parse_threads(n_chains):
    """OS threads for a native parse over ``n_chains`` independent serial
    range-decoder chains (the DCT partitions of a frame, or the G streams
    of a GOP batch): one per chain, capped by cores, which scale them
    near-linearly; on a 1-core host the serial interleaved loop wins.
    Override with ALFALFA_PARSE_THREADS=N (0/1 = serial)."""
    env = os.environ.get("ALFALFA_PARSE_THREADS")
    if env is not None:
        try:
            return max(1, min(int(env), n_chains))
        except ValueError:
            pass
    return max(1, min(os.cpu_count() or 1, n_chains))


def parse_tokens(partitions, mb_rows, mb_cols, coeff_probs, skip, y2_coded,
                 coeffs_out, has_nonzero_out, sparse=False):
    """Token-parse a whole frame. partitions: list of bytes.

    coeffs_out (r, c, 25, 16) int16 (or None) and has_nonzero_out (r, c)
    uint8 are filled in place.  With sparse=True also returns the nonzero
    coefficients as (idx, val) arrays (flat indices into the dense layout).
    Returns True on success, or (idx, val) when sparse.

    Multi-partition streams decode their partitions wavefront-parallel
    over OS threads (vp8_parse_tokens_mt) — bit-identical output."""
    lib = _load()
    data = b"".join(partitions)
    offsets = np.zeros(len(partitions) + 1, np.int64)
    np.cumsum([len(p) for p in partitions], out=offsets[1:])
    probs = np.ascontiguousarray(coeff_probs, np.uint8)
    skip_u8 = np.ascontiguousarray(skip, np.uint8)
    y2_u8 = np.ascontiguousarray(y2_coded, np.uint8)
    if coeffs_out is not None:
        assert coeffs_out.flags.c_contiguous and coeffs_out.dtype == np.int16
    threads = parse_threads(len(partitions))

    def call(*tail):
        return lib.vp8_parse_tokens_mt(
            threads, data, offsets.ctypes.data, len(partitions),
            mb_rows, mb_cols, probs.ctypes.data, skip_u8.ctypes.data,
            y2_u8.ctypes.data,
            None if coeffs_out is None else coeffs_out.ctypes.data,
            has_nonzero_out.ctypes.data, *tail)

    if not sparse:
        return call(None, None, None) == 0
    # usual case is bounded by the bitstream length (>= 2 bits/coeff), but
    # extreme probabilities can beat that; retry at the true dense bound
    # (mb_rows*mb_cols*25*16) on overflow instead of losing the fast path
    for cap in (max(4096, 4 * len(data) + 16), mb_rows * mb_cols * 25 * 16):
        sp_idx = np.empty(cap, np.int32)
        sp_val = np.empty(cap, np.int16)
        sp_meta = np.array([0, cap], np.int64)
        rc = call(sp_idx.ctypes.data, sp_val.ctypes.data,
                  sp_meta.ctypes.data)
        if rc == 0:
            n = int(sp_meta[0])
            return sp_idx[:n], sp_val[:n]
        if rc != -2:  # not a capacity overflow: genuine parse failure
            break
    return None


_simdlib = None
_SIMD_SRC = os.path.join(_HERE, "tokensimd.cc")


def _load_simd():
    """The AVX-512 engine's library, or None when the host lacks AVX-512
    (the library builds everywhere and reports it).  A failed build
    raises."""
    global _simdlib
    if _simdlib is None:
        from alfalfa_tpu_torch.native._build import load_library
        lib = load_library(_SIMD_SRC)
        if lib.vp8_token_simd_supported():
            lib.vp8_parse_tokens_gop_simd.restype = ctypes.c_int
            lib.vp8_parse_tokens_gop_simd.argtypes = (
                [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6
                + [ctypes.c_void_p] * 7)
            _simdlib = lib
        else:
            _simdlib = False
    return _simdlib or None


def simd_supported():
    """Whether the AVX-512 token engine runs on this host."""
    return _load_simd() is not None


def token_engine(engine):
    """The SIMD library a GOP token parse under ``engine`` runs, or None
    for the scalar parser.  "simd" raises where the host lacks AVX-512;
    "auto" takes the engine only on hosts with 1-2 cores."""
    if engine not in ENGINES:
        raise ValueError("token engine %r is not one of %s"
                         % (engine, ENGINES))
    if engine == "scalar" or (engine == "auto"
                              and (os.cpu_count() or 1) > 2):
        return None
    lib = _load_simd()
    if lib is None and engine == "simd":
        raise RuntimeError("the AVX-512 token engine is not supported on "
                           "this host")
    return lib


def _simd_call(lib, threads, su, bufs, mb_rows, mb_cols):
    """One SIMD engine invocation; the scalar call's return codes plus -1
    for inputs the engine does not take (G > 32; the caller parses
    them with the scalar engine)."""
    return lib.vp8_parse_tokens_gop_simd(
        max(1, int(threads)), su["G"], mb_rows, mb_cols, su["data"],
        su["off1"].ctypes.data, su["probs"].ctypes.data,
        su["skip_u8"].ctypes.data, su["y2_u8"].ctypes.data,
        su["has_nonzero_out"].ctypes.data,
        bufs["sp_delta"].ctypes.data, bufs["sp_val"].ctypes.data,
        bufs["desc_pos"].ctypes.data, bufs["desc_extra"].ctypes.data,
        bufs["vesc_pos"].ctypes.data, bufs["vesc_val"].ctypes.data,
        bufs["seg_meta"].ctypes.data)


def _gop_setup(frame_parts, coeff_probs_list, skip_all, y2_all,
               has_nonzero_out):
    """Shared input marshalling for the GOP token-parse entry points."""
    G = len(frame_parts)
    data = b"".join(p for parts in frame_parts for p in parts)
    nparts = np.array([len(parts) for parts in frame_parts], np.int32)
    part_base = np.zeros(G, np.int32)
    offsets = np.zeros(int(nparts.sum()) + G, np.int64)
    k = 0
    pos = 0
    for g, parts in enumerate(frame_parts):
        part_base[g] = k
        offsets[k] = pos
        for p in parts:
            pos += len(p)
            k += 1
            offsets[k] = pos
        k += 1
    probs = np.ascontiguousarray(
        np.stack([np.asarray(p, np.uint8) for p in coeff_probs_list]))
    skip_u8 = np.ascontiguousarray(skip_all, np.uint8)
    y2_u8 = np.ascontiguousarray(y2_all, np.uint8)
    assert has_nonzero_out.flags.c_contiguous
    frame_bytes = [sum(len(p) for p in parts) for parts in frame_parts]
    # single-partition batches also carry plain per-stream offsets for the
    # SIMD engine (streams are concatenated contiguously)
    off1 = None
    if all(int(n) == 1 for n in nparts):
        off1 = np.zeros(G + 1, np.int64)
        off1[:G] = offsets[0::2][:G]
        off1[G] = len(data)
    return dict(G=G, data=data, nparts=nparts, part_base=part_base,
                offsets=offsets, probs=probs, skip_u8=skip_u8, y2_u8=y2_u8,
                has_nonzero_out=has_nonzero_out, frame_bytes=frame_bytes,
                off1=off1)


def _gop_buffers(su, dense_g, scale):
    """Output buffers + segment metadata for one capacity scale."""
    G = su["G"]
    caps = [min(dense_g, scale * b + 4096) if scale else dense_g
            for b in su["frame_bytes"]]
    # u8 deltas escape at >255 (~1.5% of records on typical q48 content;
    # was ~0.05% with the old u16 threshold) — size the lists for ~6%
    ecaps = [c // 16 + 256 for c in caps]
    seg_meta = np.zeros(6 * G + 2, np.int64)
    np.cumsum(caps, out=seg_meta[1:G + 1])
    np.cumsum(ecaps, out=seg_meta[2 * G + 2:3 * G + 2])
    cap = int(seg_meta[G])
    ecap = int(seg_meta[3 * G + 1])
    return dict(seg_meta=seg_meta,
                sp_delta=np.empty(cap, np.uint8),
                sp_val=np.empty(cap, np.int8),
                desc_pos=np.empty(ecap, np.int32),
                desc_extra=np.empty(ecap, np.int32),
                vesc_pos=np.empty(ecap, np.int32),
                vesc_val=np.empty(ecap, np.int16))


def _gop_args(su, bufs, mb_rows, mb_cols):
    return (su["G"], mb_rows, mb_cols, su["data"],
            su["offsets"].ctypes.data, su["nparts"].ctypes.data,
            su["part_base"].ctypes.data, su["probs"].ctypes.data,
            su["skip_u8"].ctypes.data, su["y2_u8"].ctypes.data,
            su["has_nonzero_out"].ctypes.data,
            bufs["sp_delta"].ctypes.data, bufs["sp_val"].ctypes.data,
            bufs["desc_pos"].ctypes.data, bufs["desc_extra"].ctypes.data,
            bufs["vesc_pos"].ctypes.data, bufs["vesc_val"].ctypes.data,
            bufs["seg_meta"].ctypes.data)


def _gop_compact(G, felems, bufs):
    """Compact the per-segment outputs into one ascending delta stream."""
    seg_meta = bufs["seg_meta"]
    sp_delta, sp_val = bufs["sp_delta"], bufs["sp_val"]
    desc_pos, desc_extra = bufs["desc_pos"], bufs["desc_extra"]
    vesc_pos, vesc_val = bufs["vesc_pos"], bufs["vesc_val"]
    counts = seg_meta[G + 1:2 * G + 1]
    dcounts = seg_meta[3 * G + 2:4 * G + 2]
    vcounts = seg_meta[4 * G + 2:5 * G + 2]
    lasts = seg_meta[5 * G + 2:6 * G + 2]
    n = int(counts.sum())
    delta = np.empty(n, np.uint8)
    val = np.empty(n, np.int8)
    dlists, vlists = [], []
    pos = 0
    prev_last = -1        # segment 0's first delta is relative to -1
    for g in range(G):
        b, c = int(seg_meta[g]), int(counts[g])
        delta[pos:pos + c] = sp_delta[b:b + c]
        val[pos:pos + c] = sp_val[b:b + c]
        eb = int(seg_meta[2 * G + 1 + g])
        dc, vc = int(dcounts[g]), int(vcounts[g])
        dp = desc_pos[eb:eb + dc] - b + pos
        de = desc_extra[eb:eb + dc].copy()
        if c:
            # re-base the segment's first delta onto the compacted
            # stream: it was emitted relative to g*felems - 1
            first = g * felems - 1 + int(delta[pos])
            if dc and desc_pos[eb] == b:
                first += int(de[0])
            want = first - prev_last
            assert want >= 1
            d8 = min(want, 255)
            delta[pos] = d8
            if dc and desc_pos[eb] == b:
                de[0] = want - d8
            elif want > 255:
                dp = np.concatenate([[pos], dp]).astype(np.int32)
                de = np.concatenate([[want - 255], de]) \
                    .astype(np.int32)
            prev_last = int(lasts[g])
        dlists.append((dp.astype(np.int32), de.astype(np.int32)))
        vlists.append((vesc_pos[eb:eb + vc] - b + pos,
                       vesc_val[eb:eb + vc]))
        pos += c
    return dict(
        delta=delta, val=val,
        desc_pos=np.concatenate([d[0] for d in dlists]).astype(np.int32),
        desc_extra=np.concatenate([d[1] for d in dlists]).astype(np.int32),
        vesc_pos=np.concatenate([v[0] for v in vlists]).astype(np.int32),
        vesc_val=np.concatenate([v[1] for v in vlists]).astype(np.int16))


def parse_tokens_gop(frame_parts, mb_rows, mb_cols, coeff_probs_list,
                     skip_all, y2_all, has_nonzero_out, threads=1,
                     engine="auto", _scales=(2, 8, 0)):
    """Token-parse G frames in one interleaved call (see bitwork.cc
    vp8_parse_tokens_gop).  frame_parts: list of G lists of partition byte
    strings; coeff_probs_list: G (4,8,3,11) u8 arrays; skip_all/y2_all/
    has_nonzero_out: (G, R, C) u8, filled in place.

    Returns the COMPACT coefficient stream as a dict:
      delta (n,) u8   — strictly positive global-index deltas; the first
                        element is relative to index -1
      val   (n,) i8   — clamped values
      desc_pos/desc_extra (m,) i32 — delta escapes (delta = 255+extra)
      vesc_pos (k,) i32 / vesc_val (k,) i16 — value escapes (replace)
    or None on parse failure.  Reconstruction: idx = cumsum(delta+esc)-1,
    ascending and unique.

    threads > 1 splits the G independent streams over that many OS threads
    (vp8_parse_tokens_gop_mt) — bit-identical output, near-linear speedup
    on multi-core hosts (the range decoder is a serial dependency chain
    that instruction-level interleaving alone cannot scale).

    ``engine`` ("auto", "scalar" or "simd", see ENGINES) picks the parser;
    both give the same bytes.  Multi-partition frames always take the
    scalar one."""
    lib = _load()
    simd = token_engine(engine)
    su = _gop_setup(frame_parts, coeff_probs_list, skip_all, y2_all,
                    has_nonzero_out)
    G = su["G"]
    dense_g = mb_rows * mb_cols * 25 * 16
    if su["off1"] is None:
        simd = None
    hist = None
    if simd is not None and engine == "auto":
        # a 1-2 core host: the scalar interleaved loop and the 8-lane
        # engine trade wins with the exact core and batch width, so each
        # runs two real steps and the faster one is kept per (G, R, C)
        hist = _ENGINE_CALIB.setdefault((G, mb_rows, mb_cols),
                                        {"scalar": [], "simd": []})
        if len(hist["scalar"]) < 2 or (
                len(hist["simd"]) >= 2
                and min(hist["scalar"]) <= min(hist["simd"])):
            simd = None
    for scale in _scales:
        bufs = _gop_buffers(su, dense_g, scale)
        rc = None
        ran = "scalar"
        t0 = time.perf_counter()
        if simd is not None:
            ran = "simd"
            rc = _simd_call(simd, threads, su, bufs, mb_rows, mb_cols)
            if rc == -1:        # the engine declined: the scalar parser
                rc = None
                ran = "scalar"
                t0 = time.perf_counter()
        if rc is None:
            args = _gop_args(su, bufs, mb_rows, mb_cols)
            if threads > 1:
                rc = lib.vp8_parse_tokens_gop_mt(int(threads), *args)
            else:
                rc = lib.vp8_parse_tokens_gop(*args)
        if rc == -2:
            continue
        if rc != 0:
            return None
        if hist is not None and scale == _scales[0]:
            # first-try runs only, so the samples compare
            hist[ran].append(time.perf_counter() - t0)
        engine_calls[ran] += 1
        return _gop_compact(G, dense_g, bufs)
    return None


class _TokenJob:
    """Handle for an in-flight async GOP token parse.  Keeps every buffer
    the C threads read or write alive until join()."""

    def __init__(self, lib, handle, su, bufs, retry):
        self._lib = lib
        self._handle = handle
        self._su = su
        self._bufs = bufs
        self._retry = retry

    def join(self):
        """Block until the worker threads finish; returns the compact
        coefficient stream dict (same as parse_tokens_gop) or None."""
        rc = self._lib.vp8_parse_tokens_gop_mt_join(
            ctypes.c_void_p(self._handle))
        self._handle = None
        if rc == 0:
            engine_calls["scalar"] += 1
            G = self._su["G"]
            return _gop_compact(G, self._retry[1] * self._retry[2] * 400,
                                self._bufs)
        if rc == -2:
            # capacity overflow (rare): re-run synchronously, larger
            return parse_tokens_gop(*self._retry[:7],
                                    threads=self._retry[7],
                                    engine="scalar", _scales=(8, 0))
        return None


_simd_worker = None


def _simd_thread():
    """The one long-lived thread that runs every asynchronous SIMD parse
    (ctypes releases the GIL), so that the engine's per-thread workspace
    (tokensimd.cc) keeps its tables and buffers from call to call."""
    global _simd_worker
    if _simd_worker is None:
        _simd_worker = ThreadPoolExecutor(1, "token-simd")
    return _simd_worker


class _SimdTokenJob:
    """Handle for an in-flight SIMD token parse on _simd_thread(); the
    buffers live until join."""

    def __init__(self, future, su, bufs, retry, dense_g):
        self._future = future
        self._su, self._bufs = su, bufs
        self._retry, self._dense_g = retry, dense_g

    def join(self):
        rc = self._future.result()
        args, threads = self._retry[:7], self._retry[7]
        if rc == 0:
            engine_calls["simd"] += 1
            return _gop_compact(self._su["G"], self._dense_g, self._bufs)
        if rc == -2:        # capacity overflow: again, larger
            return parse_tokens_gop(*args, threads=threads, engine="simd",
                                    _scales=(8, 0))
        if rc == -1:        # the engine declined: the scalar parser
            return parse_tokens_gop(*args, threads=threads,
                                    engine="scalar")
        return None


class _SyncTokenJob:
    """1-thread degenerate of _TokenJob: runs the parse at join() time.
    On a single-core host a background thread just timeshares the core
    with the caller's packing work, so the serial interleaved call
    wins."""

    def __init__(self, args, threads, engine):
        self._args, self._threads, self._engine = args, threads, engine

    def join(self):
        return parse_tokens_gop(*self._args, threads=self._threads,
                                engine=self._engine)


def parse_tokens_gop_async(frame_parts, mb_rows, mb_cols, coeff_probs_list,
                           skip_all, y2_all, has_nonzero_out, threads=1,
                           engine="auto"):
    """Start the GOP token parse on background OS threads and return a
    job whose join() yields parse_tokens_gop's result.  The caller
    overlaps its frame-packing work with the bit-serial decode.  Returns
    None if the native library rejects the inputs (caller falls back to
    the synchronous path).  ``engine`` as parse_tokens_gop's."""
    _load()         # raise now (not at join) if the library is missing
    args = (frame_parts, mb_rows, mb_cols, coeff_probs_list, skip_all,
            y2_all, has_nonzero_out)
    simd = token_engine(engine)
    if simd is not None and (os.cpu_count() or 1) > 1:
        su = _gop_setup(frame_parts, coeff_probs_list, skip_all, y2_all,
                        has_nonzero_out)
        if su["off1"] is not None:
            # the engine packs 8 chains into one thread's zmm lanes; it
            # runs on the worker thread so the caller's packing overlaps
            dense_g = mb_rows * mb_cols * 25 * 16
            bufs = _gop_buffers(su, dense_g, 2)
            future = _simd_thread().submit(_simd_call, simd, threads, su,
                                           bufs, mb_rows, mb_cols)
            return _SimdTokenJob(future, su, bufs, args + (threads,),
                                 dense_g)
    if threads <= 1 or simd is not None:
        return _SyncTokenJob(args, threads, engine)
    lib = _load()
    su = _gop_setup(frame_parts, coeff_probs_list, skip_all, y2_all,
                    has_nonzero_out)
    dense_g = mb_rows * mb_cols * 25 * 16
    bufs = _gop_buffers(su, dense_g, 2)
    handle = lib.vp8_parse_tokens_gop_mt_start(
        max(1, int(threads)), *_gop_args(su, bufs, mb_rows, mb_cols))
    if not handle:
        return None
    return _TokenJob(lib, handle, su, bufs, args + (threads,))


def parse_frame_header(data, key_frame):
    """Native whole-frame-header scalar parse.  Returns (out_i32[64],
    tok_flags, tok_vals, mv_flags, mv_vals, state_i64[4]) or None when the
    stream needs the Python parser (unsupported features)."""
    from alfalfa_tpu_torch.bitstream import tables as T
    lib = _load()
    out = np.zeros(64, np.int32)
    tok_flags = np.zeros(1056, np.uint8)
    tok_vals = np.zeros(1056, np.uint8)
    mv_flags = np.zeros(38, np.uint8)
    mv_vals = np.zeros(38, np.uint8)
    state = np.zeros(4, np.int64)
    global _HDR_PROBS
    if _HDR_PROBS is None:
        _HDR_PROBS = (
            np.ascontiguousarray(T.COEFF_UPDATE_PROBS.reshape(-1), np.uint8),
            np.ascontiguousarray(T.MV_UPDATE_PROBS.reshape(-1), np.uint8))
    tok_up, mv_up = _HDR_PROBS
    data = bytes(data)
    rc = lib.vp8_parse_frame_header(
        data, len(data), int(key_frame), out.ctypes.data, tok_up.ctypes.data,
        tok_flags.ctypes.data, tok_vals.ctypes.data, mv_up.ctypes.data,
        mv_flags.ctypes.data, mv_vals.ctypes.data, state.ctypes.data)
    if rc != 0:
        return None
    return out, tok_flags, tok_vals, mv_flags, mv_vals, state


_HDR_PROBS = None


def parse_flagged_literals(bd, update_probs, n, width):
    """Native parse of n Flagged<Unsigned<width>> header elements, resuming
    from Python BoolDecoder ``bd`` (state advanced in place).  Returns
    (flags u8[n], vals u8[n])."""
    lib = _load()
    data = bytes(bd.data)
    state = np.array([bd.pos, bd.range, bd.value, bd.bit_count], np.int64)
    up = np.ascontiguousarray(update_probs, np.uint8)
    flags = np.zeros(n, np.uint8)
    vals = np.zeros(n, np.uint8)
    lib.vp8_parse_flagged_literals(
        data, len(data), state.ctypes.data, n, width, up.ctypes.data,
        flags.ctypes.data, vals.ctypes.data)
    bd.pos = int(state[0])
    bd.range = int(state[1])
    bd.value = int(state[2])
    bd.bit_count = int(state[3])
    return flags, vals


def _check(rc, entry):
    if rc != 0:
        raise RuntimeError("%s failed (rc=%d)" % (entry, rc))


def _restore(be, buf, state, length):
    """Hands a native writer's output and coder state back to ``be``."""
    be.output[:] = buf[:int(length[0])].tobytes()
    be.range = int(state[0])
    be.bottom = int(state[1])
    be.bit_count = int(state[2])


def serialize_tokens(arrays, coeff_probs, n_parts):
    """Native DCT-token serialization (serializer.cc:596-737 semantics).
    Returns a list of n_parts partition byte strings."""
    lib = _load()
    co = arrays.coeffs
    if co is None:
        co = arrays.densify_coeffs()
    co = np.ascontiguousarray(co, np.int16)
    skip = np.ascontiguousarray(arrays.skip_coeff, np.uint8)
    y2c = np.ascontiguousarray(arrays.y2_coded, np.uint8)
    probs = np.ascontiguousarray(coeff_probs, np.uint8)
    R, C = arrays.mb_rows, arrays.mb_cols
    # worst-case bound: ~2 bytes/coeff + flush slack
    cap = max(4096, co.nbytes // max(1, n_parts) * 2 + 4096)
    out = np.zeros(n_parts * cap, np.uint8)
    lens = np.zeros(n_parts, np.int64)
    rc = lib.vp8_serialize_tokens(
        co.ctypes.data, skip.ctypes.data, y2c.ctypes.data, R, C,
        probs.ctypes.data, n_parts, out.ctypes.data, cap, lens.ctypes.data)
    _check(rc, "vp8_serialize_tokens")
    return [out[i * cap:i * cap + int(lens[i])].tobytes()
            for i in range(n_parts)]


_TREE_TABLES = {}


def _tree_tables(tree_id, tree_arr):
    """(bits, prob_idx, len) path tables (stride 8) for a VP8 coding tree."""
    if tree_id not in _TREE_TABLES:
        from alfalfa_tpu_torch.encoder.serializer import _paths
        table = _paths(tree_id, tree_arr)
        n = max(table) + 1
        bits = np.zeros((n, 8), np.uint8)
        idx = np.zeros((n, 8), np.uint8)
        lens = np.zeros(n, np.uint8)
        for leaf, path in table.items():
            lens[leaf] = len(path)
            for k, (b, pi) in enumerate(path):
                bits[leaf, k] = b
                idx[leaf, k] = pi
        _TREE_TABLES[tree_id] = (bits, idx, lens)
    return _TREE_TABLES[tree_id]


def write_kf_modes(be, arrays, prob_skip):
    """Append all keyframe MB headers (skip flag + mode trees) to Python
    BoolEncoder ``be`` natively."""
    from alfalfa_tpu_torch.bitstream import tables as T
    lib = _load()
    R, C = arrays.mb_rows, arrays.mb_cols
    cap = len(be.output) + R * C * 64 + 4096
    buf = np.zeros(cap, np.uint8)
    buf[:len(be.output)] = np.frombuffer(bytes(be.output), np.uint8)
    state = np.array([be.range, be.bottom, be.bit_count], np.int64)
    length = np.array([len(be.output)], np.int64)

    yb, yi, yl = _tree_tables("kf_y", T.KF_Y_MODE_TREE)
    bb, bi, bl = _tree_tables("bmode", T.B_MODE_TREE)
    ub, ui, ul = _tree_tables("uv", T.UV_MODE_TREE)
    yprobs = np.ascontiguousarray(T.KF_Y_MODE_PROBS, np.uint8)
    kfb = np.ascontiguousarray(T.KF_B_MODE_PROBS, np.uint8)
    uvprobs = np.ascontiguousarray(T.KF_UV_MODE_PROBS, np.uint8)
    ym = np.ascontiguousarray(arrays.ymode, np.int8)
    bm = np.ascontiguousarray(arrays.bmode, np.int8)
    uvm = np.ascontiguousarray(arrays.uvmode, np.int8)
    skip = np.ascontiguousarray(arrays.skip_coeff, np.uint8)

    rc = lib.vp8_write_kf_modes(
        state.ctypes.data, buf.ctypes.data, cap, length.ctypes.data, R, C,
        ym.ctypes.data, bm.ctypes.data, uvm.ctypes.data, skip.ctypes.data,
        int(prob_skip is not None), int(prob_skip or 0),
        yb.ctypes.data, yi.ctypes.data, yl.ctypes.data, yprobs.ctypes.data,
        bb.ctypes.data, bi.ctypes.data, bl.ctypes.data, kfb.ctypes.data,
        ub.ctypes.data, ui.ctypes.data, ul.ctypes.data, uvprobs.ctypes.data)
    _check(rc, "vp8_write_kf_modes")
    _restore(be, buf, state, length)


def write_flagged_literals(be, probs_flat, flags_flat, vals_flat, bits):
    """Append a flagged-literal run (flag vs probs_flat[i], then a
    ``bits``-wide literal where flags_flat[i]) to Python BoolEncoder
    ``be`` natively."""
    lib = _load()
    n = int(probs_flat.size)
    cap = len(be.output) + 2 * n + 4096
    buf = np.zeros(cap, np.uint8)
    buf[:len(be.output)] = np.frombuffer(bytes(be.output), np.uint8)
    state = np.array([be.range, be.bottom, be.bit_count], np.int64)
    length = np.array([len(be.output)], np.int64)
    probs = np.ascontiguousarray(probs_flat, np.uint8)
    flags = np.ascontiguousarray(flags_flat, np.uint8)
    vals = np.ascontiguousarray(vals_flat, np.uint8)
    rc = lib.vp8_write_flagged_literals(
        state.ctypes.data, buf.ctypes.data, cap, length.ctypes.data,
        probs.ctypes.data, flags.ctypes.data, vals.ctypes.data, n, bits)
    _check(rc, "vp8_write_flagged_literals")
    _restore(be, buf, state, length)


_INTER_TABLES = None


def _inter_tables():
    """Packed tree-path arena + MV-partition tables for the native
    interframe MB-header writer (order must match bitwork.cc)."""
    global _INTER_TABLES
    if _INTER_TABLES is None:
        from alfalfa_tpu_torch.bitstream import tables as T
        specs = [("mv_ref", T.MV_REF_TREE), ("submv_ref", T.SUBMV_REF_TREE),
                 ("split_mv", T.SPLIT_MV_TREE), ("small_mv", T.SMALL_MV_TREE),
                 ("y", T.Y_MODE_TREE), ("bmode", T.B_MODE_TREE),
                 ("uv", T.UV_MODE_TREE), ("segment_id", T.SEGMENT_ID_TREE)]
        arena = np.zeros(len(specs) * 272, np.uint8)
        for t, (tid, tree) in enumerate(specs):
            bits, idx, lens = _tree_tables(tid, tree)
            n = bits.shape[0]
            base = t * 272
            arena[base:base + n * 8] = bits.reshape(-1)
            arena[base + 128:base + 128 + n * 8] = idx.reshape(-1)
            arena[base + 256:base + 256 + n] = lens
        mvpart_n = np.zeros(4, np.uint8)
        mvpart_first = np.zeros((4, 16, 2), np.uint8)
        for pid, parts in enumerate(T.MV_PARTITIONS):
            mvpart_n[pid] = len(parts)
            for p, part in enumerate(parts):
                first_c, first_r = part[0]
                mvpart_first[pid, p] = (first_r, first_c)
        c2p = np.ascontiguousarray(T.MV_COUNTS_TO_PROBS, np.uint8)
        submv2 = np.ascontiguousarray(T.SUBMV_REF_PROBS2, np.uint8)
        split = np.ascontiguousarray(T.SPLIT_MV_PROBS, np.uint8)
        binv = np.ascontiguousarray(T.INVARIANT_B_MODE_PROBS, np.uint8)
        _INTER_TABLES = (arena, mvpart_n, mvpart_first, c2p, submv2, split,
                         binv)
    return _INTER_TABLES


def write_inter_modes(be, arrays, header, frame_probs, flipped_map):
    """Append all interframe MB headers (segment id, skip flag, reference,
    inter/intra modes, MVs) to Python BoolEncoder ``be`` natively.  Exact
    mirror of FrameSerializer._serialize_mb_header
    (reference encoder/serializer.cc:165-316)."""
    lib = _load()
    arena, mvpart_n, mvpart_first, c2p, submv2, split, binv = _inter_tables()
    R, C = arrays.mb_rows, arrays.mb_cols
    cap = len(be.output) + R * C * 96 + 4096
    buf = np.zeros(cap, np.uint8)
    buf[:len(be.output)] = np.frombuffer(bytes(be.output), np.uint8)
    state = np.array([be.range, be.bottom, be.bit_count], np.int64)
    length = np.array([len(be.output)], np.int64)

    seg = header.update_segmentation
    has_seg = int(seg is not None and seg.update_mb_segmentation_map)
    if has_seg:
        seg_probs = np.ascontiguousarray(seg.segment_tree_probs(), np.uint8)
        seg_map = np.ascontiguousarray(arrays.segment_update, np.int8)
    else:
        seg_probs = np.zeros(3, np.uint8)
        seg_map = np.zeros(1, np.int8)

    ym = np.ascontiguousarray(arrays.ymode, np.int8)
    bm = np.ascontiguousarray(arrays.bmode, np.int8)
    uvm = np.ascontiguousarray(arrays.uvmode, np.int8)
    skip = np.ascontiguousarray(arrays.skip_coeff, np.uint8)
    ref = np.ascontiguousarray(arrays.ref, np.int8)
    smv = np.ascontiguousarray(arrays.sub_mv, np.int16)
    flip = np.ascontiguousarray(flipped_map, np.uint8)
    pid = np.ascontiguousarray(arrays.splitmv_pid, np.int8)
    yp = np.ascontiguousarray(frame_probs.y_mode_probs, np.uint8)
    uvp = np.ascontiguousarray(frame_probs.uv_mode_probs, np.uint8)
    mvp = np.ascontiguousarray(frame_probs.mv_probs, np.uint8)
    prob_skip = header.prob_skip_false

    rc = lib.vp8_write_inter_modes(
        state.ctypes.data, buf.ctypes.data, cap, length.ctypes.data, R, C,
        ym.ctypes.data, bm.ctypes.data, uvm.ctypes.data, skip.ctypes.data,
        int(prob_skip is not None), int(prob_skip or 0),
        ref.ctypes.data, smv.ctypes.data, flip.ctypes.data, pid.ctypes.data,
        seg_map.ctypes.data, has_seg, seg_probs.ctypes.data,
        int(header.prob_inter), int(header.prob_references_last),
        int(header.prob_references_golden),
        yp.ctypes.data, uvp.ctypes.data, binv.ctypes.data, mvp.ctypes.data,
        c2p.ctypes.data, submv2.ctypes.data, split.ctypes.data,
        arena.ctypes.data, mvpart_n.ctypes.data, mvpart_first.ctypes.data)
    _check(rc, "vp8_write_inter_modes")
    _restore(be, buf, state, length)


def count_token_branches(arrays, counts=None):
    """Native accumulate_token_branches (serializer.cc:456-594)."""
    lib = _load()
    if counts is None:
        counts = np.zeros((4, 8, 3, 11, 2), np.int64)
    assert counts.flags.c_contiguous and counts.dtype == np.int64
    co = arrays.coeffs
    if co is None:
        co = arrays.densify_coeffs()
    co = np.ascontiguousarray(co, np.int16)
    skip = np.ascontiguousarray(arrays.skip_coeff, np.uint8)
    y2c = np.ascontiguousarray(arrays.y2_coded, np.uint8)
    rc = lib.vp8_count_token_branches(
        co.ctypes.data, skip.ctypes.data, y2c.ctypes.data,
        arrays.mb_rows, arrays.mb_cols, counts.ctypes.data)
    _check(rc, "vp8_count_token_branches")
    return counts


def hash_range(seed, values_u64):
    lib = _load()
    arr = np.ascontiguousarray(values_u64, np.uint64)
    return int(lib.vp8_hash_range(ctypes.c_uint64(seed), arr.ctypes.data,
                                  arr.size))


def hash_bytes(seed, values_u8):
    lib = _load()
    arr = np.ascontiguousarray(values_u8, np.uint8)
    return int(lib.vp8_hash_bytes(ctypes.c_uint64(seed), arr.ctypes.data,
                                  arr.size))


_mblib = None
_MB_SRC = os.path.join(_HERE, "mbparse.cc")


def _load_mb():
    global _mblib
    if _mblib is not None:
        return _mblib
    from alfalfa_tpu_torch.native._build import load_library
    lib = load_library(_MB_SRC)
    lib.vp8_parse_mb_headers_gop.restype = ctypes.c_int
    lib.vp8_parse_mb_headers_gop.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
        + [ctypes.c_void_p] * 6 + [ctypes.c_void_p] * 10)
    lib.vp8_parse_mb_headers_gop_mt.restype = ctypes.c_int
    lib.vp8_parse_mb_headers_gop_mt.argtypes = (
        [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
        + [ctypes.c_void_p] * 6 + [ctypes.c_void_p] * 10)
    lib.vp8_parse_mb_headers.restype = ctypes.c_int
    lib.vp8_parse_mb_headers.argtypes = (
        [ctypes.c_void_p, ctypes.c_int64,
         ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_uint8,
         ctypes.c_uint8, ctypes.c_uint8, ctypes.c_uint8,
         ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 4
        + [ctypes.c_void_p] * 10
        + [ctypes.c_void_p])
    _mblib = lib
    return lib


def parse_mb_headers_gop(items, mb_rows, mb_cols, kf_b_mode_probs,
                         threads=1):
    """MB-header parse of G frames interleaved in one native call.

    items: list of (bd, header, frame_probs, key_frame) after the frame
    header phase; each bd is advanced in place.  Returns per-frame dicts of
    output slabs (views into the (G, ...) batch arrays), or None if the
    native library is unavailable.  threads > 1 fans contiguous stream
    ranges over OS threads (bit-identical; the per-stream decoder chains
    are independent)."""
    lib = _load_mb()
    G = len(items)
    R, C = mb_rows, mb_cols
    n = R * C
    data = b"".join(bytes(bd.data) for bd, _, _, _ in items)
    off = np.zeros(G + 1, np.int64)
    np.cumsum([len(bd.data) for bd, _, _, _ in items], out=off[1:])
    states = np.zeros((G, 4), np.int64)
    params = np.zeros((G, 12), np.int32)
    seg_probs = np.full((G, 3), 255, np.uint8)
    ymp = np.zeros((G, 4), np.uint8)
    uvp = np.zeros((G, 3), np.uint8)
    mvp = np.zeros((G, 2, 19), np.uint8)
    for g, (bd, header, fp, key_frame) in enumerate(items):
        states[g] = (bd.pos, bd.range, bd.value, bd.bit_count)
        us = header.update_segmentation
        params[g] = (int(key_frame),
                     int(us is not None and us.update_mb_segmentation_map),
                     int(header.prob_skip_false is not None),
                     header.prob_skip_false or 0,
                     0 if key_frame else header.prob_inter,
                     0 if key_frame else header.prob_references_last,
                     0 if key_frame else header.prob_references_golden,
                     0 if key_frame else int(header.sign_bias_golden),
                     0 if key_frame else int(header.sign_bias_alternate),
                     0, 0, 0)
        if us is not None:
            seg_probs[g] = us.segment_tree_probs()
        ymp[g] = np.asarray(fp.y_mode_probs, np.uint8)
        uvp[g] = np.asarray(fp.uv_mode_probs, np.uint8)
        mvp[g] = np.asarray(fp.mv_probs, np.uint8)
    kfb = np.ascontiguousarray(kf_b_mode_probs, np.uint8)

    out = dict(
        ymode=np.zeros((G, R, C), np.int8),
        uvmode=np.zeros((G, R, C), np.int8),
        ref=np.zeros((G, R, C), np.int8),
        segment_update=np.full((G, R, C), -1, np.int16),
        skip=np.zeros((G, R, C), np.uint8),
        y2_coded=np.zeros((G, R, C), np.uint8),
        bmode=np.zeros((G, R, C, 4, 4), np.int8),
        sub_mv=np.zeros((G, R, C, 4, 4, 2), np.int16),
        uv_mv=np.zeros((G, R, C, 2, 2, 2), np.int16),
        splitmv_pid=np.full((G, R, C), -1, np.int8))
    rc = lib.vp8_parse_mb_headers_gop_mt(
        max(1, int(threads)), G, R, C,
        data, off.ctypes.data, states.ctypes.data,
        params.ctypes.data, seg_probs.ctypes.data, ymp.ctypes.data,
        uvp.ctypes.data, kfb.ctypes.data, mvp.ctypes.data,
        out["ymode"].ctypes.data, out["uvmode"].ctypes.data,
        out["ref"].ctypes.data, out["segment_update"].ctypes.data,
        out["skip"].ctypes.data, out["y2_coded"].ctypes.data,
        out["bmode"].ctypes.data, out["sub_mv"].ctypes.data,
        out["uv_mv"].ctypes.data, out["splitmv_pid"].ctypes.data)
    if rc != 0:
        return None
    for g, (bd, _, _, _) in enumerate(items):
        bd.pos, bd.range = int(states[g, 0]), int(states[g, 1])
        bd.value, bd.bit_count = int(states[g, 2]), int(states[g, 3])
    return out


def parse_mb_headers(bd, mb_rows, mb_cols, key_frame, read_segment_id,
                     seg_tree_probs, prob_skip, prob_inter, prob_last,
                     prob_golden, sign_bias_golden, sign_bias_alt,
                     y_mode_probs, uv_mode_probs, kf_b_mode_probs, mv_probs,
                     arrays, segment_update):
    """Runs the MB-header parse natively, resuming from Python BoolDecoder
    ``bd`` (whose state is advanced on success). Fills ``arrays`` fields and
    ``segment_update`` ((r, c) int16, -1 = no update) in place."""
    lib = _load_mb()
    data = bytes(bd.data)
    out_state = np.zeros(4, np.int64)
    seg_probs = np.ascontiguousarray(seg_tree_probs, np.uint8)
    ymp = np.ascontiguousarray(y_mode_probs, np.uint8)
    uvp = np.ascontiguousarray(uv_mode_probs, np.uint8)
    kfb = np.ascontiguousarray(kf_b_mode_probs, np.uint8)
    mvp = np.ascontiguousarray(mv_probs, np.uint8)
    skip_u8 = np.zeros((mb_rows, mb_cols), np.uint8)
    y2_u8 = np.zeros((mb_rows, mb_cols), np.uint8)
    rc = lib.vp8_parse_mb_headers(
        data, len(data), bd.pos, bd.range, bd.value, bd.bit_count,
        mb_rows, mb_cols, int(key_frame),
        int(read_segment_id), seg_probs.ctypes.data,
        int(prob_skip is not None), prob_skip or 0,
        prob_inter, prob_last, prob_golden,
        int(sign_bias_golden), int(sign_bias_alt),
        ymp.ctypes.data, uvp.ctypes.data, kfb.ctypes.data, mvp.ctypes.data,
        arrays.ymode.ctypes.data, arrays.uvmode.ctypes.data,
        arrays.ref.ctypes.data, segment_update.ctypes.data,
        skip_u8.ctypes.data, y2_u8.ctypes.data, arrays.bmode.ctypes.data,
        arrays.sub_mv.ctypes.data, arrays.uv_mv.ctypes.data,
        arrays.splitmv_pid.ctypes.data,
        out_state.ctypes.data)
    if rc != 0:
        return False
    arrays.skip_coeff[:] = skip_u8.astype(bool)
    arrays.y2_coded[:] = y2_u8.astype(bool)
    bd.pos = int(out_state[0])
    bd.range = int(out_state[1])
    bd.value = int(out_state[2])
    bd.bit_count = int(out_state[3])
    return True
