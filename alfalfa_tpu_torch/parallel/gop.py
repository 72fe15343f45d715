"""Batched GOP decoding: chunk parallelism on ONE device.

Independent chunks (GOPs) let one GPU decode G of them in lockstep: the
host token parse runs ahead (it only needs header-level state, never
pixels), per-frame parse arrays are stacked on a leading GOP axis, and a
single batched reconstruction step advances all G chunks at once, so the
sequential wavefronts amortise G-fold.

Host half (``parse_frame_batch``, the packing helpers) is numpy + the
native parsers; the device half is PyTorch tensors on ``device`` with the
two CUDA kernels of ``decoder.reconstruct_torch`` underneath.
"""
import time

import numpy as np
import torch

from alfalfa_tpu_torch.bitstream.header import (UncompressedChunk,
                                                CORRUPTED_RESIDUES)
from alfalfa_tpu_torch.decoder.parse import FrameParser, FrameArrays
from alfalfa_tpu_torch.decoder import reconstruct_torch as _RT
from alfalfa_tpu_torch.native import bitwork
from alfalfa_tpu_torch.parallel.upload import PinnedStaging
from alfalfa_tpu_torch.parallel.upload import pack_upload as _pack_upload
from alfalfa_tpu_torch.parallel.upload import unpack_upload as _unpack_upload
from alfalfa_tpu_torch.state.decoder_state import DecoderState
from alfalfa_tpu_torch.bitstream import tables as _T
from alfalfa_tpu_torch.util import tracing

_COEFF_KEYS = ("coeff_delta", "coeff_val8", "desc_pos", "desc_extra",
               "vesc_pos", "vesc_val")


def _pack_merged(batch):
    """ONE host->device transfer per step: [fixed-size step segments |
    variable-capacity coefficient stream] in a single uint8 buffer, with
    the coefficient spec's offsets rebased past the fixed region.  A single
    transfer is right on PCIe too: each copy has a fixed cost."""
    batch_c = {k: batch.pop(k) for k in _COEFF_KEYS}
    mega_r, spec_r = _pack_upload(batch)
    mega_c, spec_c = _pack_upload(batch_c)
    off = mega_r.size
    spec_c = tuple((k, d, s, o + off, n) for (k, d, s, o, n) in spec_c)
    return np.concatenate([mega_r, mega_c]), spec_r, spec_c, off


def _scatter_coeffs(G, R, C, coeff_delta, coeff_val8, desc_pos, desc_extra,
                    vesc_pos, vesc_val):
    """Compact coefficient stream -> dense (G, R, C, 25, 16) int16:
    indices by prefix sum, then a scatter of unique ascending indices (pad
    deltas of 1 walk into the scratch slots past the dense layout).

    Pad entries of the escape lists carry position == cap, one past the
    stream; the work tensors hold one extra slot so those land there
    instead of out of range (torch raises or corrupts memory where the
    reference's scatter dropped them)."""
    ne = G * R * C * 25 * 16
    cap = coeff_delta.shape[0]
    dev = coeff_delta.device
    delta = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    delta[:cap] = coeff_delta               # uint8 -> int32 before the sum
    delta.index_add_(0, desc_pos.to(torch.int64), desc_extra)
    cidx = torch.cumsum(delta[:cap], dim=0, dtype=torch.int64) - 1
    cval = torch.zeros(cap + 1, dtype=torch.int16, device=dev)
    cval[:cap] = coeff_val8
    # escape positions are unique apart from the pads, which all write 0 to
    # the spare slot: the result does not depend on write order
    cval[vesc_pos.to(torch.int64)] = vesc_val
    dense = torch.zeros(ne + cap, dtype=torch.int16, device=dev)
    dense[cidx] = cval[:cap]
    return dense[:ne].reshape(G, R, C, 25, 16)


_QF_KEYS = ("y_dc", "y_ac", "y2_dc", "y2_ac", "uv_dc", "uv_ac")


def chroma_mvs(sub_mv):
    """(..., 4, 4, 2) luma sub-MVs -> (..., 2, 2, 2) chroma MVs: quadrant
    sums with symmetric rounding, sign(q) * ((|q| + 4) >> 3)."""
    lead = sub_mv.shape[:-3]
    q = sub_mv.reshape(lead + (2, 2, 2, 2, 2)).sum(dim=(-4, -2)) \
        .to(torch.int32)
    return torch.sign(q) * ((torch.abs(q) + 4) >> 3)


def loop_filter_limits(lf_base, sharpness, y2c, nz, key_frame):
    """Per-MB loop-filter parameters from the base level (G, R, C) and the
    per-GOP sharpness (G,): (level, interior, mb_limit, sb_limit, hev,
    skip_sb).  hev gets its third step (level >= 20) on interframes only;
    the interior limit never drops below 1."""
    sharp = sharpness[:, None, None]
    fl = torch.clamp(lf_base, 0, 63)
    shifted = fl >> torch.where(sharp > 4, 2, 1).to(torch.int32)
    interior = torch.where(sharp > 0, torch.minimum(shifted, 9 - sharp), fl)
    interior = torch.clamp(interior, min=1)
    hev = (fl >= 15).to(torch.int32) + (fl >= 40).to(torch.int32)
    if not key_frame:
        hev = hev + (fl >= 20).to(torch.int32)
    level = torch.where(lf_base > 0, fl, torch.zeros_like(fl))
    skip_sb = y2c & ~nz
    return (level, interior, (fl + 2) * 2 + interior, fl * 2 + interior,
            hev, skip_sb)


def update_references(refs, raster, fls, key_frame):
    """New (G, 3, H, W) reference stack (last, golden, alternate) of one
    plane after a frame.  fls: (5, G) = copy_to_alternate, copy_to_golden,
    refresh_golden, refresh_alternate, refresh_last.  Order matters: the
    alternate is updated first and golden <- alternate reads the UPDATED
    alternate; then the three refresh selects.  Key frames set all three."""
    if key_frame:
        return raster[:, None].expand(-1, 3, -1, -1).contiguous()

    def sel(cond, a, b):
        return torch.where(cond[:, None, None], a, b)

    last, gold, alt = refs[:, 0], refs[:, 1], refs[:, 2]
    copy_alt, copy_gold = fls[0], fls[1]
    alt = sel(copy_alt == 1, last, sel(copy_alt == 2, gold, alt))
    gold = sel(copy_gold == 1, last, sel(copy_gold == 2, alt, gold))
    gold = sel(fls[2] != 0, raster, gold)
    alt = sel(fls[3] != 0, raster, alt)
    last = sel(fls[4] != 0, raster, last)
    return torch.stack([last, gold, alt], dim=1)


class BatchedGopDecoder:
    """Decode G independent, frame-type-aligned GOPs in lockstep.

    All GOPs must have the same dimensions and the same per-position frame
    type (true for fixed-GOP encodes and for ExCamera chunks).  Decoded
    rasters stay on ``device``; fetch only what you need.
    ``token_engine`` picks the host token parser (native/bitwork.py
    ENGINES: "auto", "scalar", or "simd", the AVX-512 engine, which
    raises here on a host without AVX-512).
    """

    def __init__(self, width, height, n_gops, device=None,
                 token_engine="auto"):
        bitwork.token_engine(token_engine)
        self.token_engine = token_engine
        self.device = torch.device("cuda" if device is None else device)
        self.width, self.height = width, height
        self.G = n_gops
        self.mb_rows = (height + 15) // 16
        self.mb_cols = (width + 15) // 16
        self.states = [DecoderState.initial(width, height)
                       for _ in range(n_gops)]
        H, W = self.mb_rows * 16, self.mb_cols * 16
        # persistent references: one (G, 3, H, W) uint8 stack per plane,
        # slots (last, golden, alternate), unpadded
        self.refs = {
            p: torch.zeros((n_gops, 3, h, w), dtype=torch.uint8,
                           device=self.device)
            for p, h, w in (("y", H, W), ("u", H // 2, W // 2),
                            ("v", H // 2, W // 2))}
        self._staging = PinnedStaging(self.device)

    # -- host side -----------------------------------------------------------

    def parse_frame_batch(self, payloads):
        """Parse one frame from each GOP (list of G byte strings).  Returns
        the stacked device inputs + flags; advances per-GOP header state.

        The bit-serial phases run as ONE native call each across the whole
        batch (MB headers, then tokens), with the G independent range-
        decoder chains interleaved so they overlap in the out-of-order
        core: the host-side mirror of the device's GOP-lockstep decode."""
        G, R, C = self.G, self.mb_rows, self.mb_cols
        with tracing.stage("parse.headers"):
            chunks = [UncompressedChunk(payloads[g], self.width,
                                        self.height) for g in range(G)]
            key_frames = {c.key_frame for c in chunks}
            if len(key_frames) != 1:
                raise ValueError("GOPs must be frame-type aligned")
            key_frame = key_frames.pop()

            parsers = [FrameParser(self.states[g], sparse_tokens=True,
                                   defer_tokens=True) for g in range(G)]
            hdr = [parsers[g].parse_header_phase(chunks[g])
                   for g in range(G)]

        clean = all(c.corruption_level == 0 for c in chunks)

        # MB headers: one interleaved native call over the batch; the
        # outputs land in (G, ...) slabs the device packing uses directly
        _t_mb = time.perf_counter()
        S = None
        if clean:
            try:
                S = bitwork.parse_mb_headers_gop(
                    [(hdr[g][2], hdr[g][0], hdr[g][1], key_frame)
                     for g in range(G)], R, C, _T.KF_B_MODE_PROBS,
                    threads=bitwork.parse_threads(G))
            except (AttributeError, OSError):
                # no native library: the Python parsers stand in on the
                # CPU only; on the card their minutes would pass for the
                # host cost, so the load error goes to the caller
                if self.device.type == "cuda":
                    raise
                S = None
        per = []
        if S is not None:
            for g in range(G):
                arrays = FrameArrays(
                    R, C,
                    ymode=S["ymode"][g], uvmode=S["uvmode"][g],
                    ref=S["ref"][g], segment=np.zeros((R, C), np.uint8),
                    skip_coeff=S["skip"][g].view(bool),
                    has_nonzero=np.zeros((R, C), bool),
                    y2_coded=S["y2_coded"][g].view(bool),
                    bmode=S["bmode"][g], sub_mv=S["sub_mv"][g],
                    uv_mv=S["uv_mv"][g], splitmv_pid=S["splitmv_pid"][g],
                    segment_update=S["segment_update"][g],
                    alloc_coeffs=False)
                parsers[g]._segment_updates = arrays.segment_update
                parsers[g]._apply_segmentation_map(arrays)
                per.append((hdr[g][0], arrays, chunks[g], hdr[g][1],
                            parsers[g]))
        else:
            for g in range(G):
                header, fp, bd = hdr[g]
                arrays = parsers[g]._parse_macroblock_headers(
                    bd, header, fp, key_frame=key_frame,
                    error_concealment=(not key_frame
                                       and chunks[g].corruption_level
                                       > CORRUPTED_RESIDUES))
                parsers[g]._apply_segmentation_map(arrays)
                per.append((header, arrays, chunks[g], fp, parsers[g]))
            S = dict(
                ymode=np.stack([p[1].ymode for p in per]),
                uvmode=np.stack([p[1].uvmode for p in per]),
                ref=np.stack([p[1].ref for p in per]),
                skip=np.stack([p[1].skip_coeff for p in per]).astype(np.uint8),
                y2_coded=np.stack([p[1].y2_coded for p in per]).astype(np.uint8),
                bmode=np.stack([p[1].bmode for p in per]),
                sub_mv=np.stack([p[1].sub_mv for p in per]),
                splitmv_pid=np.stack([p[1].splitmv_pid for p in per]))

        # token decode: the G independent streams start NOW on background
        # OS threads (one native call; bit-serial range decode is the parse
        # wall) and everything below that doesn't need coefficients — MV /
        # quantizer / loop-filter packing — overlaps with them; the join
        # sits right before the coefficient-stream packing
        tracing.add("parse.mb_headers", time.perf_counter() - _t_mb)
        _t_tok = time.perf_counter()
        token_job = None
        hnz = None
        if clean:
            try:
                frame_parts = [
                    p[2].dct_partitions(
                        1 << p[0].log2_number_of_dct_partitions)
                    for p in per]
                hnz = np.zeros((G, R, C), np.uint8)
                token_job = bitwork.parse_tokens_gop_async(
                    frame_parts, R, C, [p[3].coeff_probs for p in per],
                    S["skip"], S["y2_coded"], hnz,
                    threads=bitwork.parse_threads(G),
                    engine=self.token_engine)
            except (AttributeError, OSError):
                if self.device.type == "cuda":
                    raise
                token_job = None

        tracing.add("parse.tok_start", time.perf_counter() - _t_tok)
        _t_pack = time.perf_counter()

        def bucket(n, floor):
            # coarse pow4 buckets; nothing on the device depends on them,
            # they keep the upload format equal to the JAX package's
            b = floor
            while b < n:
                b <<= 2
            return b

        smv = S["sub_mv"]
        mv0 = smv[:, :, :, 0, 0, :]
        # non-SPLITMV MBs have all 16 sub-MVs equal by construction, so the
        # parser's splitmv_pid flag replaces a 16x sub-MV equality scan
        # (rarely a SPLITMV MB's sub-MVs are all equal — the sparse escape
        # path still decodes those correctly, just less compactly)
        split = S["splitmv_pid"] >= 0
        sidx = np.flatnonzero(split)
        cap_s = bucket(len(sidx), 256)
        split_idx = np.zeros(cap_s, np.int32)
        split_val = np.zeros((cap_s, 4, 4, 2), np.int16)
        split_idx[:len(sidx)] = sidx
        split_val[:len(sidx)] = smv.reshape(-1, 4, 4, 2)[sidx]
        # pad entries re-write slot split_idx[0] (or MB 0) with its own value
        pad_row = sidx[0] if len(sidx) else 0
        split_idx[len(sidx):] = pad_row
        split_val[len(sidx):] = smv.reshape(-1, 4, 4, 2)[pad_row]

        # per-segment dequant factor tables + segment map (device gathers);
        # one vectorized quantizer_values call over the (G, 4) index grid
        qf_table = np.zeros((self.G, len(_QF_KEYS), 4), np.int16)
        qi = np.zeros((G, 4), np.int32)
        dq = np.zeros((G, 5), np.int32)
        for g, (header, _arrays, _chunk, _fp, _parser) in enumerate(per):
            qin = header.quant_indices
            seg = self.states[g].segmentation
            if seg is not None:
                # uint8 wrap before clamp (frame.cc:192-197 semantics,
                # QuantIndices.quantizer)
                adj = np.asarray(seg.quantizer_adjustments[:4], np.int32)
                qi[g] = (adj + (0 if seg.absolute else qin.y_ac_qi)) & 0xFF
            else:
                qi[g] = qin.y_ac_qi
            dq[g] = (qin.y_dc or 0, qin.y2_dc or 0, qin.y2_ac or 0,
                     qin.uv_dc or 0, qin.uv_ac or 0)
        from alfalfa_tpu_torch.bitstream.tables import quantizer_values
        qv = quantizer_values(qi, dq[:, 0:1], dq[:, 1:2], dq[:, 2:3],
                              dq[:, 3:4], dq[:, 4:5])
        for ki, k in enumerate(_QF_KEYS):
            qf_table[:, ki] = qv[k]

        # loop-filter base level per MB (pre-clip, with segment/mode/ref
        # adjustments; _frame_lf_params semantics) — limits derive on
        # device.  Per-lane scalars gathered into (G, ...) tables, then one
        # vectorized expression over the whole batch.
        def lf_base_batch():
            lf_level = np.array([p[0].loop_filter_level for p in per],
                                np.int32)
            has_segf = np.zeros(G, bool)
            seg_abs = np.zeros(G, bool)
            segf = np.zeros((G, 4), np.int32)
            has_fa = np.zeros(G, bool)
            fa_ref = np.zeros((G, 4), np.int32)
            fa_mode = np.zeros((G, 4), np.int32)
            for g in range(G):
                seg = self.states[g].segmentation
                if seg is not None:
                    has_segf[g] = True
                    seg_abs[g] = seg.absolute
                    segf[g] = seg.filter_adjustments[:4]
                fa = self.states[g].filter_adjustments
                if fa is not None:
                    has_fa[g] = True
                    fa_ref[g] = fa.ref_adjustments[:4]
                    fa_mode[g] = fa.mode_adjustments[:4]
            gi = np.arange(G)[:, None, None]
            segmap = np.stack([p[1].segment for p in per]).astype(np.int32)
            lfg = lf_level[:, None, None]
            base = np.where(
                has_segf[:, None, None],
                segf[gi, segmap]
                + np.where(seg_abs[:, None, None], 0, lfg),
                lfg)
            ref = S["ref"].astype(np.int32)
            ymode = S["ymode"].astype(np.int32)
            mode_adj = np.where(
                ref == _T.CURRENT_FRAME,
                np.where(ymode == _T.B_PRED, fa_mode[:, 0:1, None], 0),
                np.where(ymode == _T.ZEROMV, fa_mode[:, 1:2, None],
                         np.where(ymode == _T.SPLITMV,
                                  fa_mode[:, 3:4, None],
                                  fa_mode[:, 2:3, None])))
            adj = np.where(has_fa[:, None, None],
                           fa_ref[gi, ref] + mode_adj, 0)
            return np.where(lfg > 0, base + adj, 0).astype(np.int16)

        # pack the small per-MB maps into two buffers.  Interframes carry
        # bmode as SPARSE escapes (B_PRED MBs only, like SPLITMV sub-MVs):
        # dense bmode would be 16 of buf8's 22 bytes/MB; keyframes keep
        # the dense layout (most MBs are B_PRED there).
        nb8 = 22 if key_frame else 6
        buf8 = np.empty((G, R, C, nb8), np.int8)
        for g, pp in enumerate(per):
            buf8[g, :, :, 0] = pp[1].segment
        buf8[:, :, :, 1] = S["y2_coded"]
        # slot 2 (has_nonzero) is filled after the token-thread join below
        buf8[:, :, :, 3] = S["ymode"]
        buf8[:, :, :, 4] = S["uvmode"]
        buf8[:, :, :, 5] = S["ref"]
        bmode_idx = bmode_val = None
        if key_frame:
            buf8[:, :, :, 6:22] = S["bmode"].reshape(G, R, C, 16)
        else:
            bflat = S["bmode"].reshape(-1, 16)
            bp = np.flatnonzero(S["ymode"].reshape(-1) == 4)   # B_PRED
            cap_b = bucket(len(bp), 64)
            bmode_idx = np.zeros(cap_b, np.int32)
            bmode_val = np.zeros((cap_b, 16), np.int8)
            bmode_idx[:len(bp)] = bp
            bmode_val[:len(bp)] = bflat[bp]
            pad_b = bp[0] if len(bp) else 0
            bmode_idx[len(bp):] = pad_b
            bmode_val[len(bp):] = bflat[pad_b]

        if key_frame:
            fl = np.zeros((5, G), np.int16)
        else:
            fl = np.array(
                [[p[0].copy_buffer_to_alternate or 0 for p in per],
                 [p[0].copy_buffer_to_golden or 0 for p in per],
                 [p[0].refresh_golden_frame for p in per],
                 [p[0].refresh_alternate_frame for p in per],
                 [p[0].refresh_last for p in per]], np.int16)
        buf16 = np.concatenate([
            mv0.ravel().astype(np.int16),
            lf_base_batch().ravel(),
            qf_table.ravel(),
            np.array([p[0].sharpness_level for p in per], np.int16),
            fl.ravel()])

        # join the token threads (they ran during all the packing above);
        # fall back to the Python token parser if the native path was
        # unavailable or failed
        tracing.add("parse.pack", time.perf_counter() - _t_pack)
        _t_join = time.perf_counter()
        batch_blocks = token_job.join() if token_job is not None else None
        tracing.add("parse.tok_join", time.perf_counter() - _t_join)
        _t_coeff = time.perf_counter()
        if batch_blocks is not None:
            S["has_nonzero"] = hnz
            for g, p in enumerate(per):
                p[1].has_nonzero[:] = hnz[g].view(bool)
        else:
            for header, arrays, chunk, fp, parser in per:
                parser._parse_tokens(chunk, header, arrays, fp)
            S["has_nonzero"] = np.stack(
                [p[1].has_nonzero for p in per]).astype(np.uint8)
        buf8[:, :, :, 2] = S["has_nonzero"]

        # Uploads are minimal: nonzero coefficients as block records (emitted directly
        # by the C token parser), one MV per macroblock with sparse SPLITMV
        # escapes, and small per-MB maps.  Chroma MVs, loop filter limits,
        # and dequant factors are re-derived on device.
        frame_elems = self.mb_rows * self.mb_cols * 25 * 16
        if batch_blocks is None:
            # fallback: per-frame elementwise sparse (token order) -> the
            # same compact delta stream the native parser emits
            sp = [p[1].coeff_sparse for p in per]
            eidx = np.concatenate(
                [idx.astype(np.int64) + g * frame_elems
                 for g, (idx, _v) in enumerate(sp)])
            eval_ = np.concatenate([v for _i, v in sp]).astype(np.int64)
            order = np.argsort(eidx, kind="stable")
            eidx, eval_ = eidx[order], eval_[order]
            d = np.diff(eidx, prepend=-1)
            dpos = np.flatnonzero(d > 255).astype(np.int32)
            vpos = np.flatnonzero((eval_ < -128) | (eval_ > 127)) \
                .astype(np.int32)
            batch_blocks = dict(
                delta=np.minimum(d, 255).astype(np.uint8),
                val=np.where((eval_ < -128) | (eval_ > 127), 0, eval_)
                .astype(np.int8),
                desc_pos=dpos,
                desc_extra=(d[dpos] - 255).astype(np.int32),
                vesc_pos=vpos, vesc_val=eval_[vpos].astype(np.int16))
        cs = batch_blocks
        n_nz = len(cs["delta"])

        def bucket2(n, floor):
            b = floor
            while b < n:
                b <<= 1
            return b

        def bucket125(n, floor):
            # geometric 1.25x buckets, 4K-element aligned: pow2 buckets
            # waste up to half the largest upload segment in transfer bytes
            b = floor
            while b < n:
                b = ((b + (b >> 2)) + 4095) & ~4095
            return b

        cap = bucket125(n_nz, 1 << 15)
        # pad deltas of 1 keep the reconstructed indices ascending and
        # unique, walking into the scratch slots past the dense layout
        coeff_delta = np.ones(cap, np.uint8)
        coeff_val8 = np.zeros(cap, np.int8)
        coeff_delta[:n_nz] = cs["delta"]
        coeff_val8[:n_nz] = cs["val"]
        ecap = bucket2(max(len(cs["desc_pos"]), len(cs["vesc_pos"])), 512)
        desc_pos = np.full(ecap, cap, np.int32)     # OOB -> dropped
        desc_extra = np.zeros(ecap, np.int32)
        vesc_pos = np.full(ecap, cap, np.int32)
        vesc_val = np.zeros(ecap, np.int16)
        desc_pos[:len(cs["desc_pos"])] = cs["desc_pos"]
        desc_extra[:len(cs["desc_extra"])] = cs["desc_extra"]
        vesc_pos[:len(cs["vesc_pos"])] = cs["vesc_pos"]
        vesc_val[:len(cs["vesc_val"])] = cs["vesc_val"]

        batch = dict(
            coeff_delta=coeff_delta, coeff_val8=coeff_val8,
            desc_pos=desc_pos, desc_extra=desc_extra,
            vesc_pos=vesc_pos, vesc_val=vesc_val,
            split_idx=split_idx, split_val=split_val,
            buf8=buf8, buf16=buf16,
        )
        if bmode_idx is not None:
            batch["bmode_idx"] = bmode_idx
            batch["bmode_val"] = bmode_val
        show = [p[2].show_frame for p in per]
        tracing.add("parse.coeff_pack", time.perf_counter() - _t_coeff)
        return key_frame, batch, None if key_frame else True, show

    # -- device side -----------------------------------------------------------

    def _upload(self, mega):
        """The merged buffer as a uint8 tensor on self.device: one
        non-blocking copy out of a pinned staging buffer."""
        return self._staging.upload(mega)

    def _step_inputs(self, key_frame, batch):
        """The unpacked upload turned into reconstruct_core_batch's
        arguments (a dict) plus the (5, G) reference-update flags."""
        G, R, C = self.G, self.mb_rows, self.mb_cols
        n_mb = G * R * C
        i32 = lambda x: x.to(torch.int32)
        buf8 = batch["buf8"]

        # unpack buf16: [mv0, lf_base, qf_table, sharpness, flags]
        b16 = batch["buf16"]
        o = 0
        mv0 = i32(b16[o:o + n_mb * 2]).reshape(G, R, C, 2)
        o += n_mb * 2
        lf_base = i32(b16[o:o + n_mb]).reshape(G, R, C)
        o += n_mb
        qf_table = i32(b16[o:o + G * 6 * 4]).reshape(G, 6, 4)
        o += G * 6 * 4
        sharpness = i32(b16[o:o + G])
        o += G
        fls = i32(b16[o:o + 5 * G]).reshape(5, G)

        seg = buf8[:, :, :, 0].to(torch.int64).reshape(G, -1)
        y2c = buf8[:, :, :, 1] != 0
        nz = buf8[:, :, :, 2] != 0
        ymode = i32(buf8[:, :, :, 3])
        uvmode = i32(buf8[:, :, :, 4])
        refsel = i32(buf8[:, :, :, 5]).contiguous()
        if buf8.shape[-1] == 22:
            bmode = buf8[:, :, :, 6:22].contiguous().view(torch.uint8)
        else:
            # interframe: sparse B_PRED escapes (the value for other MBs is
            # never read).  Pad entries repeat a real index with its own
            # value, so duplicate writes are equal writes.
            bmode = torch.zeros((n_mb, 16), dtype=torch.uint8,
                                device=buf8.device)
            bmode[batch["bmode_idx"].to(torch.int64)] = \
                batch["bmode_val"].view(torch.uint8)
            bmode = bmode.reshape(G, R, C, 16)

        coeffs = _scatter_coeffs(G, R, C, *(batch[k] for k in _COEFF_KEYS))

        sub_mv = mv0[:, :, :, None, None, :].expand(G, R, C, 4, 4, 2) \
            .reshape(n_mb, 4, 4, 2).clone()
        # pad entries repeat a real index with its own value (see above)
        sub_mv[batch["split_idx"].to(torch.int64)] = i32(batch["split_val"])
        sub_mv = sub_mv.reshape(G, R, C, 4, 4, 2)
        uv_mv = chroma_mvs(sub_mv).contiguous()

        qf = {k: torch.gather(qf_table[:, ki], 1, seg).reshape(G, R, C)
              for ki, k in enumerate(_QF_KEYS)}
        lfp = loop_filter_limits(lf_base, sharpness, y2c, nz, key_frame)

        return dict(coeffs=coeffs, qf=qf, y2_coded=y2c, has_nonzero=nz,
                    ymode=ymode, uvmode=uvmode, bmode=bmode, ref_sel=refsel,
                    sub_mv=sub_mv, uv_mv=uv_mv, lf_params=lfp), fls

    def _step(self, key_frame, batch):
        """One device step over the unpacked upload: returns (y, u, v)
        planes and replaces self.refs."""
        inputs, fls = self._step_inputs(key_frame, batch)
        y, u, v = _RT.reconstruct_core_batch(key_frame, refs=self.refs,
                                             **inputs)
        # the stacks are rebuilt, not updated in place: the planes handed
        # to the caller never alias a reference that a later frame rewrites
        self.refs = {p: update_references(self.refs[p], r, fls, key_frame)
                     for p, r in (("y", y), ("u", u), ("v", v))}
        return y, u, v

    def _submit(self, key_frame, batch):
        """Pack, upload and run one parsed frame position."""
        with tracing.stage("gop.upload", sync=True):
            mega, spec_r, spec_c, _off = _pack_merged(batch)
            dev = self._upload(mega)
        with tracing.stage("gop.device", sync=True):
            return self._step(key_frame, _unpack_upload(dev, spec_r + spec_c))

    def decode_frame_batch(self, payloads):
        """Parse + reconstruct one frame position across all GOPs.
        Returns ((y, u, v), show): (G, H, W) luma + chroma tensors on
        self.device (macroblock-padded dims)."""
        with tracing.stage("gop.parse"):
            key_frame, batch, _flags, show = self.parse_frame_batch(payloads)
        return self._submit(key_frame, batch), show

    def decode_stream(self, payload_batches):
        """Pipelined decode: yields ((y, u, v), show) per frame position.

        The host-side bit-serial parse of frame i+1 never depends on the
        device, and kernel launches are asynchronous: frame i is uploaded
        and enqueued, then frame i+1 is parsed while the device works, and
        only then is frame i handed to the caller (who may synchronise on
        it).  Per step the wall time tends to max(parse, upload + device)
        instead of their sum.  With tracing enabled the stages synchronise
        and the overlap is lost."""
        pending = None
        for payloads in payload_batches:
            with tracing.stage("gop.parse"):
                key_frame, batch, _flags, show = \
                    self.parse_frame_batch(payloads)
            if pending is not None:
                yield pending
            pending = (self._submit(key_frame, batch), show)
        if pending is not None:
            yield pending


def decode_gops(gop_payloads, width, height, device=None):
    """Decode G aligned GOPs; returns per-GOP lists of (y, u, v) tensors
    for shown frames."""
    G = len(gop_payloads)
    n_frames = {len(g) for g in gop_payloads}
    if len(n_frames) != 1:
        raise ValueError("GOPs must have equal frame counts")
    dec = BatchedGopDecoder(width, height, G, device=device)
    out = [[] for _ in range(G)]
    for f in range(n_frames.pop()):
        (y, u, v), show = dec.decode_frame_batch(
            [gop_payloads[g][f] for g in range(G)])
        for g in range(G):
            if show[g]:
                out[g].append((y[g], u[g], v[g]))
    return out


# ---------------------------------------------------------------------------
# GOP-parallel steps over several devices (ExCamera-style chunks)
#
# The JAX package expresses these with shard_map over a device mesh: one
# controller, a chunk (or a sub-batch of frames) per device, and the small
# exit state exchanged by collectives.  Here one process drives the mesh
# as well: a mesh is an ordered list of torch devices, each shard is
# dispatched to its device in turn (launches are asynchronous, so separate
# cards overlap), an all_gather is a copy onto every device, a pmean a
# float32 mean of the shard means, and a ppermute a non-blocking copy to
# the next device.  Every op is out of place, so a mesh that repeats a
# device (["cuda:0"] * 4, ["cpu"] * 4) aliases nothing across shards.
#
# Results that the JAX package shards over the mesh come back as a list
# over the shards, each on its device; replicated results as a list of
# copies, one on each mesh device.
# ---------------------------------------------------------------------------

def make_gop_mesh(devices=None):
    """The ordered list of torch devices a step runs over: ``devices``
    (names or torch.device; repeats allowed), or every visible CUDA
    device."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    mesh = [torch.device(d) for d in devices]
    if not mesh:
        raise ValueError("a GOP mesh needs at least one device")
    return mesh


def _shards(mesh, n):
    """Split a leading axis of ``n`` items evenly over the mesh: the
    (start, stop) of each shard."""
    if n % len(mesh):
        raise ValueError("%d items do not split over %d devices"
                         % (n, len(mesh)))
    b = n // len(mesh)
    return [(d * b, (d + 1) * b) for d in range(len(mesh))]


def _on(x, dev, dtype=None):
    """A host array or tensor as a tensor on ``dev`` (a copy, never an
    alias of the argument)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
        return x.to(dev, dtype or x.dtype)
    return x.to(dev, dtype or x.dtype, copy=True)


def _gather(mesh, parts):
    """all_gather: the parts (each on its shard's device) concatenated,
    one copy on every mesh device."""
    return [torch.cat([p.to(dev, non_blocking=True) for p in parts])
            for dev in mesh]


def gop_decode_step(mesh, mb_rows, mb_cols, key_frame=False):
    """A sharded decode step (JAX parallel/gop.py gop_decode_step): a
    batch of per-frame parse arrays, split over the mesh along its leading
    (frame) axis, is reconstructed frame by frame on each shard's device
    (reconstruct_torch.reconstruct_core: K3, K4, K5).

    The returned function takes example_frame_batch's tuple (coeffs, qf,
    y2c, nz, ym, uvm, bm, refsel, smv, uvmv, ry, ru, rv, lfp; ry, ru, rv
    each frame's (4, H, W) reference stacks, slots 1-3 last, golden,
    alternate) and returns (y, u, v, exit_y, mean_energy): the shards'
    (b, H, W) / (b, H/2, W/2) uint8 planes; every shard's last luma plane
    gathered as (n, H, W) onto every device (what a serial rebase pass
    consumes); the mean |luma| of the whole batch, float32, a scalar on
    every device (the mean of the shard means)."""
    R, C = mb_rows, mb_cols

    def step(coeffs, qf, y2c, nz, ym, uvm, bm, refsel, smv, uvmv, ry, ru,
             rv, lfp):
        outs = []
        for dev, (a, b) in zip(mesh, _shards(mesh, len(coeffs))):
            planes = []
            for f in range(a, b):
                at = lambda x, dt=None: _on(x[f], dev, dt)
                refs = None if key_frame else {
                    p: tuple(at(s)[1:4].unbind(0))
                    for p, s in (("y", ry), ("u", ru), ("v", rv))}
                planes.append(_RT.reconstruct_core(
                    key_frame, at(coeffs, torch.int32),
                    {k: at(q, torch.int32) for k, q in qf.items()},
                    at(y2c, torch.bool), at(nz, torch.bool),
                    at(ym, torch.int32), at(uvm, torch.int32),
                    at(bm, torch.uint8).reshape(R, C, 16),
                    at(refsel, torch.int32), at(smv, torch.int32),
                    at(uvmv, torch.int32), refs,
                    tuple(at(x) for x in lfp)))
            outs.append([torch.stack(p) for p in zip(*planes)])
        y, u, v = ([o[k] for o in outs] for k in range(3))
        exit_y = _gather(mesh, [p[-1:] for p in y])
        means = [p.to(torch.float32).abs().mean() for p in y]
        mean_energy = [torch.stack([m.to(dev) for m in means]).mean()
                       for dev in mesh]
        return y, u, v, exit_y, mean_energy

    return step


def example_frame_batch(n_frames, mb_rows, mb_cols, seed=0):
    """A valid batch of parse arrays for dry runs (JAX parallel/gop.py
    example_frame_batch, the same numbers from the same seed)."""
    rng = np.random.RandomState(seed)
    R, C, B = mb_rows, mb_cols, n_frames
    coeffs = rng.randint(-80, 80, (B, R, C, 25, 16)).astype(np.int32)
    qf = {k: np.full((B, R, C), v, np.int32)
          for k, v in (("y_dc", 8), ("y_ac", 6), ("y2_dc", 16),
                       ("y2_ac", 9), ("uv_dc", 8), ("uv_ac", 6))}
    y2c = rng.rand(B, R, C) < 0.7
    nz = np.ones((B, R, C), bool)
    ym = np.where(y2c, 0, 4).astype(np.int32)   # DC_PRED / B_PRED mix
    uvm = rng.randint(0, 4, (B, R, C)).astype(np.int32)
    bm = rng.randint(0, 10, (B, R, C, 4, 4)).astype(np.int32)
    refsel = rng.randint(1, 4, (B, R, C)).astype(np.int32)
    smv = rng.randint(-64, 64, (B, R, C, 4, 4, 2)).astype(np.int32)
    uvmv = rng.randint(-64, 64, (B, R, C, 2, 2, 2)).astype(np.int32)
    H, W = R * 16, C * 16
    ry = rng.randint(0, 256, (B, 4, H, W)).astype(np.uint8)
    ru = rng.randint(0, 256, (B, 4, H // 2, W // 2)).astype(np.uint8)
    rv = rng.randint(0, 256, (B, 4, H // 2, W // 2)).astype(np.uint8)
    lvl = np.full((B, R, C), 20, np.int32)
    lfp = (lvl, np.full((B, R, C), 9, np.int32),
           np.full((B, R, C), 53, np.int32),
           np.full((B, R, C), 49, np.int32), np.full((B, R, C), 2, np.int32),
           np.zeros((B, R, C), bool))
    return (coeffs, qf, y2c, nz, ym, uvm, bm, refsel, smv, uvmv,
            ry, ru, rv, lfp)


def encode_step_inputs(mb_rows, mb_cols, n_chunks, seed=0):
    """gop_encode_step's arguments to K7 (the JAX package's, from the same
    seed): the chunks' (n, H, W), (n, H/2, W/2), (n, H/2, W/2) uint8
    planes, the six quantizer factors of qi 48 and its RD multipliers."""
    from alfalfa_tpu_torch.bitstream.header import QuantIndices
    from alfalfa_tpu_torch.encoder.costs import rd_multipliers
    from alfalfa_tpu_torch.encoder.encode_intra import QUANT_KEYS

    H, W = mb_rows * 16, mb_cols * 16
    rng = np.random.RandomState(seed)
    oy = rng.randint(0, 256, (n_chunks, H, W)).astype(np.uint8)
    ou = rng.randint(0, 256, (n_chunks, H // 2, W // 2)).astype(np.uint8)
    ov = rng.randint(0, 256, (n_chunks, H // 2, W // 2)).astype(np.uint8)
    q = QuantIndices(y_ac_qi=48).quantizer()
    quant = [int(q[k]) for k in QUANT_KEYS]
    return (oy, ou, ov), quant, rd_multipliers(quant[1])


def gop_encode_step(mesh, mb_rows, mb_cols, n_chunks, seed=0):
    """GOP-parallel key-frame encode (JAX parallel/gop.py gop_encode_step,
    the same seeded planes at qi 48, encode_step_inputs): each chunk's
    first frame through K7 (ops/enc_intra_cuda.encode_kf_frame) on its
    shard's device, the exit reconstructions gathered onto every device
    (what a pipelined rebase consumes; reencode.cc:305-381).  Returns
    (exit_y: (n, H, W) uint8 on every device, coeffs: the shards' (b, R, C,
    400) int16)."""
    R, C = mb_rows, mb_cols
    (oy, ou, ov), quant, (rm, dm) = encode_step_inputs(R, C, n_chunks, seed)
    # after encoder.encode_intra, which imports this module back
    from alfalfa_tpu_torch.ops.enc_intra_cuda import encode_kf_frame
    coeffs, recon = [], []
    for dev, (a, b) in zip(mesh, _shards(mesh, n_chunks)):
        out = [encode_kf_frame(_on(oy[f], dev), _on(ou[f], dev),
                               _on(ov[f], dev), quant, rm, dm)
               for f in range(a, b)]
        coeffs.append(torch.stack([o[0].reshape(R, C, 400) for o in out]))
        recon.append(out[-1][2][None])
    return _gather(mesh, recon), coeffs


def gop_rebase_chain(mesh, mb_rows, mb_cols, n_frames):
    """The pipelined chunk rebase over the mesh (JAX parallel/gop.py
    gop_rebase_chain; reencode.cc:305-381 and ExCamera's pipeline): shard
    d holds chunk d's frames (originals and fixed prediction modes and
    vectors); the exit references go around the ring, one hop a chunk.

    Each frame is the rebase's residue update (one call of the residue
    kernel, as encoder/reencode_device.py makes it) and refreshes
    LAST; a chunk's final reconstruction leaves as all three references
    and hops to the next shard's device.  Only the active shard runs at
    each ring step (the JAX package computes on every device and masks,
    as SPMD requires; the result is the same).

    The returned function takes (oy, ou, ov, refsel, smv, uvmv, splitmv,
    qs, ry0, ru0, rv0) as the JAX one does (the chunk axis first; qs (N,
    8) the six quantizer factors and two zeros; ry0, ru0, rv0 the entry
    (4, H, W) reference stacks, slots 1-3 last, golden, alternate) and
    returns (coeffs: the shards' (1, F, n_mb, 400) int16, nz: the shards'
    (1, F, n_mb) bool, exit_y: the last chunk's exit luma stack (4, H, W)
    on every device, as the ring leaves it back on the first)."""
    from alfalfa_tpu_torch.ops.rebase import mb_words, split_out
    from alfalfa_tpu_torch.ops.rebase_cuda import rebase_frame

    R, C = mb_rows, mb_cols

    def chain(oy, ou, ov, refsel, smv, uvmv, splitmv, qs, ry0, ru0, rv0):
        spans = _shards(mesh, len(oy))
        if any(b - a != 1 for a, b in spans):
            raise ValueError("the rebase ring takes one chunk a device")
        dev = mesh[0]
        refs = {p: tuple(_on(s, dev, torch.uint8)[1:4].unbind(0))
                for p, s in (("y", ry0), ("u", ru0), ("v", rv0))}
        coeffs, nonzero = [], []
        for d, dev in enumerate(mesh):
            # the ppermute: the exit references hop onto this shard
            refs = {p: tuple(s.to(dev, non_blocking=True) for s in slots)
                    for p, slots in refs.items()}
            quant = [int(x) for x in np.asarray(qs[d])[:6]]
            co_f, nz_f = [], []
            for f in range(n_frames):
                at = lambda x, dt: _on(x[d][f], dev, dt)
                orig = [at(x, torch.uint8) for x in (oy, ou, ov)]
                # the chain is inter-only: a whole-vector or SPLITMV mode
                host = lambda x: np.asarray(x[d][f])
                ymode = np.where(host(splitmv), _T.SPLITMV, _T.NEWMV)
                zero = np.zeros((R, C), np.int32)
                words = _on(mb_words(host(refsel), ymode, zero,
                                     np.zeros((R, C, 4, 4), np.int32),
                                     host(smv), host(uvmv)), dev,
                            torch.int32)
                recon = [torch.empty_like(o) for o in orig]
                co, nz, _ = split_out(rebase_frame(orig, refs, words, quant,
                                                   recon))
                co_f.append(co.reshape(R * C, 400))
                nz_f.append(nz.reshape(R * C))
                # refresh LAST; golden and alternate carry on
                refs = {p: (r,) + refs[p][1:]
                        for p, r in zip(("y", "u", "v"), recon)}
            coeffs.append(torch.stack(co_f)[None])
            nonzero.append(torch.stack(nz_f)[None])
            # chunk exit: the final reconstruction as all three references
            refs = {p: (s[0],) * 3 for p, s in refs.items()}
        # the last hop brings the exit references back to the first device
        exit_y = refs["y"][0].to(mesh[0], non_blocking=True)[None] \
            .repeat(4, 1, 1)
        return coeffs, nonzero, [exit_y.to(dev, copy=True) for dev in mesh]

    return chain


def rebase_chain_inputs_from_ivf(path, n_chunks, n_frames, device=None):
    """gop_rebase_chain's inputs from a real stream (JAX parallel/gop.py
    rebase_chain_inputs_from_ivf, the same arrays): decoded rasters as the
    chunks' content, the stream's own reference selections, sub-vectors,
    SPLITMV layout and quantizer as the fixed prediction, and the key
    frame's reconstruction as the entry references.  Intra macroblocks
    become ZEROMV from LAST, as the chain's residue update is inter-only.
    The frames are decoded by the port's Decoder on ``device`` (CUDA by
    default) and parsed by its FrameParser on the host; returns numpy
    arrays."""
    from alfalfa_tpu_torch.decoder.decoder import Decoder
    from alfalfa_tpu_torch.util.ivf import IVFReader

    ivf = IVFReader(path)
    W, H = ivf.width, ivf.height
    R, C = (H + 15) // 16, (W + 15) // 16
    dec = Decoder(W, H, device=device)
    rasters, metas, qis = [], [], []
    for i in range(len(ivf)):
        payload = ivf.frame(i)
        chunk = UncompressedChunk(payload, W, H)
        header, arrays, _ = FrameParser(dec.state.copy()).parse(chunk)
        _show, raster = dec.decode_frame(payload)
        rasters.append(raster.to_host())
        if not chunk.key_frame:
            metas.append((arrays.ref.copy(), arrays.sub_mv.copy(),
                          arrays.uv_mv.copy(),
                          (arrays.splitmv_pid >= 0).copy()))
            qis.append(header.quant_indices)
    kf_y, kf_u, kf_v = rasters[0]

    def stack4(p):
        return np.broadcast_to(p[None], (4,) + p.shape).copy()

    oy = np.zeros((n_chunks, n_frames, R * 16, C * 16), np.int32)
    ou = np.zeros((n_chunks, n_frames, R * 8, C * 8), np.int32)
    ov = np.zeros((n_chunks, n_frames, R * 8, C * 8), np.int32)
    refsel = np.zeros((n_chunks, n_frames, R, C), np.int32)
    smv = np.zeros((n_chunks, n_frames, R, C, 4, 4, 2), np.int32)
    uvmv = np.zeros((n_chunks, n_frames, R, C, 2, 2, 2), np.int32)
    splitmv = np.zeros((n_chunks, n_frames, R, C), bool)
    for d in range(n_chunks):
        for f in range(n_frames):
            k = (d * n_frames + f) % len(metas)
            oy[d, f], ou[d, f], ov[d, f] = rasters[k + 1]
            ref, sub_mv, uv_mv, sp = metas[k]
            intra = ref == 0
            refsel[d, f] = np.where(intra, 1, ref)      # intra -> LAST
            smv[d, f] = np.where(intra[:, :, None, None, None], 0, sub_mv)
            uvmv[d, f] = np.where(intra[:, :, None, None, None], 0, uv_mv)
            splitmv[d, f] = sp & ~intra
    qs = np.zeros((n_chunks, 8), np.int32)
    for d in range(n_chunks):
        qv = qis[d % len(qis)].quantizer()
        qs[d] = [qv["y_dc"], qv["y_ac"], qv["y2_dc"], qv["y2_ac"],
                 qv["uv_dc"], qv["uv_ac"], 0, 0]
    return (oy, ou, ov, refsel, smv, uvmv, splitmv, qs), \
        (stack4(kf_y), stack4(kf_u), stack4(kf_v))


def dryrun_multichip(n_devices, devices=None):
    """Run the three steps over an ``n_devices``-shard mesh (``devices``,
    or every visible CUDA device) at tiny shapes and check them: the
    decode step on example_frame_batch, and on a real interframe
    (inter_176x144_q96.ivf's frame 1) replicated on every shard against
    the single-frame Decoder; the encode step; the rebase ring on
    inter_320x240_q40.ivf's real content.  The counterpart of the JAX
    package's __graft_entry__.dryrun_multichip."""
    import os
    from alfalfa_tpu_torch.decoder.decoder import Decoder
    from alfalfa_tpu_torch.decoder.lf_params import frame_lf_params
    from alfalfa_tpu_torch.util.ivf import IVFReader

    mesh = make_gop_mesh(devices)
    n = len(mesh)
    if n != n_devices:
        raise ValueError("need %d devices, the mesh has %d" % (n_devices, n))
    fixtures = os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "tests", "fixtures")
    R, C = 3, 4
    y, _u, _v, exit_y, energy = gop_decode_step(mesh, R, C)(
        *example_frame_batch(n, R, C))
    assert [tuple(t.shape) for t in y] == [(1, R * 16, C * 16)] * n
    assert all(e.shape[0] == n for e in exit_y)
    assert all(torch.isfinite(e) for e in energy)

    # a real interframe on every shard equals the serial decoder's
    ivf = IVFReader(os.path.join(fixtures, "inter_176x144_q96.ivf"))
    dec = Decoder(ivf.width, ivf.height, device=mesh[0])
    dec.decode_frame(ivf.frame(0))
    refs = [r.to_host() for r in (dec.references.last, dec.references.last,
                                  dec.references.golden,
                                  dec.references.alternative)]
    _show, want = dec.copy().decode_frame(ivf.frame(1))
    header, arrays, _ = FrameParser(dec.state).parse(
        UncompressedChunk(ivf.frame(1), ivf.width, ivf.height))
    R, C = arrays.mb_rows, arrays.mb_cols
    qf = _RT._frame_quant_factors(header, dec.state, arrays.segment)
    lfp = frame_lf_params(header, arrays, dec.state, False)

    def rep(x):
        return np.broadcast_to(np.asarray(x)[None], (n,) + np.shape(x))

    stacks = [rep(np.stack([r[p] for r in refs])) for p in range(3)]
    y, u, v, exit_y, _ = gop_decode_step(mesh, R, C)(
        rep(arrays.densify_coeffs()), {k: rep(q) for k, q in qf.items()},
        rep(arrays.y2_coded), rep(arrays.has_nonzero), rep(arrays.ymode),
        rep(arrays.uvmode), rep(arrays.bmode), rep(arrays.ref),
        rep(arrays.sub_mv), rep(arrays.uv_mv), *stacks,
        tuple(rep(x) for x in lfp))
    want = want.to_host()
    for d in range(n):
        for got, w, name in zip((y[d][0], u[d][0], v[d][0]), want, "YUV"):
            if not np.array_equal(got.cpu().numpy(), w):
                raise AssertionError("mesh shard %d: %s differs" % (d, name))
    assert all(e.shape[0] == n for e in exit_y)

    # the encode step, then the rebase ring on real 320x240 content
    ey, eco = gop_encode_step(mesh, R, C, n)
    assert all(e.shape == (n, R * 16, C * 16) for e in ey)
    assert sum(c.shape[0] for c in eco) == n
    inputs, refs0 = rebase_chain_inputs_from_ivf(
        os.path.join(fixtures, "inter_320x240_q40.ivf"), n, 2,
        device=mesh[0])
    co, _nz, exit_y = gop_rebase_chain(mesh, 15, 20, 2)(*inputs, *refs0)
    assert all(tuple(c.shape) == (1, 2, 300, 400) for c in co)
    assert all(tuple(e.shape) == (4, 240, 320) for e in exit_y)
