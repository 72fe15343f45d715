"""The persistent row walks of K1, K4, K5, K7, K8, K9, K10 and the
rebase's residue kernel on the CPU, no JAX: the plain versions driven one
macroblock at a time in orders that row walkers under the progress-flag
rule of csrc/row_sched.cuh could produce, with the very lags the wrappers
pass to the card (``wavefront_cuda.ROW_LAG``, ``intra_cuda.ROW_LAG``,
``lf_cuda.ROW_LAG``, ``enc_intra_cuda.ROW_LAG``, ``enc_inter_cuda.ROW_LAG``,
``enc_decide_cuda.ROW_LAG``, ``enc_intra_fixup_cuda.ROW_LAG``, and the
residue kernel's lag by mode, ``rebase_cuda.ROW_LAG_WHOLE`` and
``ROW_LAG_BPRED``), are ``torch.equal`` to the anti-diagonal (or raster)
order; one lag less gives a different result, so each rule is tight and
the test can fail.  And the decision
chain K8 and K9 share, the loop filter K1 and K5 share, and the intra
reconstruction step K1 and K4 share, are each defined once under csrc/.
"""
import functools
import pathlib
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)    # many tiny ops: threads only add contention

from alfalfa_tpu_torch.bitstream import tables as T
from alfalfa_tpu_torch.bitstream.header import QuantIndices
from alfalfa_tpu_torch.decoder.lf_params import loopfilter_params
from alfalfa_tpu_torch.encoder import Encoder
from alfalfa_tpu_torch.encoder import encode_inter as EI
from alfalfa_tpu_torch.encoder import encode_inter_fast as EF
from alfalfa_tpu_torch.encoder import encoder as ENC
from alfalfa_tpu_torch.encoder.costs import rd_multipliers
from alfalfa_tpu_torch.encoder.encode_intra import QUANT_KEYS
from alfalfa_tpu_torch.encoder.trellis import token_costs_pm
from alfalfa_tpu_torch.decoder import reconstruct_torch as RT
from alfalfa_tpu_torch.ops import enc_batch, enc_decide, enc_decide_cuda, \
    enc_inter, enc_inter_cuda, enc_intra, enc_intra_cuda, \
    enc_intra_fixup_cuda, intra_cuda, lf_cuda, rebase, rebase_cuda, \
    transforms, wavefront_cuda
from alfalfa_tpu_torch.ops.enc_intra_fixup import intra_fixup_frame_plain
from alfalfa_tpu_torch.ops import wavefront
from alfalfa_tpu_torch.ops.wavefront import (diagonals, intra_frame_plain,
                                             loop_filter_plain, row_order,
                                             tile, wavefront_decode_plain)
from alfalfa_tpu_torch.parallel import gop
from alfalfa_tpu_torch.util.ivf import IVFReader

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests" / "fixtures"))
from gen_inputs import gen_clip  # noqa: E402

SEEDS = (0, 1, 2)


def _k8_args(w, h, qis, quality="best", two_pass=False, scene_cut=False):
    """K8's arguments for frame 1 of a synthetic clip after frame 0 as a key
    frame; ``scene_cut``: frame 0 against frame 1's reconstruction, with
    frame 0's luma turned upside down (most macroblocks go intra)."""
    clip = gen_clip(w, h, 2, seed=31)
    key, frame = clip[0], clip[1]
    if scene_cut:
        key, frame = clip[1], (np.ascontiguousarray(clip[0][0][::-1]),
                               clip[0][1], clip[0][2])
    enc = Encoder(w, h, device="cpu", quality=quality, two_pass=two_pass)
    enc.encode_with_quantizer(key, qis[0], key_frame=True)
    return EI.kernel_inputs(enc, frame, [QuantIndices(y_ac_qi=q) for q in qis])


def _k8_in_order(args, order):
    """encode_inter_frame_plain's outputs with each quantizer's frame walked
    in ``order``."""
    oy, ou, ov, ly, lu, lv, scalars, tables, realtime, tc = args
    tables = tuple(t.to(torch.int64) for t in tables)
    tcs = None if tc is None else tc.to(torch.int64)
    outs = [enc_inter._encode_frame(oy, ou, ov, ly, lu, lv,
                                    [int(x) for x in sc], tables,
                                    bool(realtime), tcs, order)
            for sc in scalars.tolist()]
    return tuple(torch.stack(x) for x in zip(*outs))


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _k9_args(w, h, qis, scene_cut=False):
    """K9's arguments as the fast path hands them over (fast_frame) for
    frame 2 of a synthetic clip after frame 0 as a key frame (``scene_cut``:
    as _k8_args)."""
    clip = gen_clip(w, h, 3, seed=23)
    key, frame = clip[0], clip[2]
    if scene_cut:
        key, frame = clip[1], (np.ascontiguousarray(clip[0][0][::-1]),
                               clip[0][1], clip[0][2])
    enc = Encoder(w, h, device="cpu", quality="rt", fast=True)
    enc.encode_with_quantizer(key, qis[0], key_frame=True)
    oy, _, _, ly, _, _, scalars, tables, rd = EF.frame_inputs(
        enc, frame, [QuantIndices(y_ac_qi=q) for q in qis])
    mbc, _ibc, mvc2p, pcost, sadcost, mvcost = tables
    icost = torch.stack([enc_batch.intra_screen_source(
        tile(oy[None], 16)[0], mbc, rm, dm) for rm, dm in rd])
    return oy, ly, scalars, icost, (mvc2p, pcost, sadcost, mvcost)


def _k9_in_order(args, order):
    oy, ly, scalars, icost, tables = args
    tables = tuple(t.to(torch.int64) for t in tables)
    return torch.stack([enc_decide._decide_frame(oy, ly, sc, icost[q],
                                                 tables, order)
                        for q, sc in enumerate(scalars.tolist())])


# ----------------------------------------------------------- the orders

@pytest.mark.parametrize("lag", [0, 1, 2, 3])
def test_row_order_obeys_the_flag_rule(lag):
    R, C = 5, 7
    for seed in SEEDS:
        order = row_order(R, C, lag, seed)
        assert sorted((r[0], c[0]) for r, c in order) == \
            [(r, c) for r in range(R) for c in range(C)]
        done = [0] * R
        for (r,), (c,) in order:
            assert c == done[r]                           # column order
            assert r == 0 or done[r - 1] >= min(c + lag, C)
            done[r] += 1
    # random interleavings: the seeds give different orders
    assert len({tuple(map(str, row_order(R, C, lag, s))) for s in SEEDS}) > 1


def test_wrappers_pass_the_lags_of_the_reads():
    """K1, K4, K5, K7 and K8 reach their above-right neighbour (diagonals
    2r + c: K1's and K4's intra prediction and K7's and K8's B_PRED read its
    pixels, K1's and K5's top edge must find the pixels its left edge
    writes), K9 and K10 their left, above and above-left (r + c): the lags
    the kernels run with are those of the diagonals the plain versions walk
    by default."""
    assert enc_inter_cuda.ROW_LAG == 2 and enc_decide_cuda.ROW_LAG == 1
    assert enc_intra_cuda.ROW_LAG == 2 and lf_cuda.ROW_LAG == 2
    assert wavefront_cuda.ROW_LAG == 2 and enc_intra_fixup_cuda.ROW_LAG == 1
    assert intra_cuda.ROW_LAG == 2
    # the residue kernel's intra macroblocks: a whole mode reads left,
    # above and above-left, B_PRED the above-right neighbour too
    assert rebase_cuda.ROW_LAG_WHOLE == 1 and rebase_cuda.ROW_LAG_BPRED == 2
    for k, lag in ((2, enc_inter_cuda.ROW_LAG), (1, enc_decide_cuda.ROW_LAG),
                   (2, enc_intra_cuda.ROW_LAG), (2, lf_cuda.ROW_LAG),
                   (2, wavefront_cuda.ROW_LAG), (2, intra_cuda.ROW_LAG),
                   (1, enc_intra_fixup_cuda.ROW_LAG),
                   (1, rebase_cuda.ROW_LAG_WHOLE),
                   (2, rebase_cuda.ROW_LAG_BPRED)):
        # every macroblock of diagonal d waits only on earlier diagonals
        for d, (rs, cs) in enumerate(diagonals(6, 9, k)):
            for r, c in zip(rs, cs):
                if r:
                    last = min(c + lag, 9) - 1    # the last one it waits for
                    assert k * (r - 1) + last < d


# --------------------------------------- the plain K8 in row-walk orders

@pytest.mark.parametrize("mode", ["best", "rt", "two-pass", "pair"])
def test_k8_row_walk_equals_diagonals(mode):
    """80x48 (3 x 5 macroblocks): best, rt, two-pass with token costs and
    the rt pair (Q = 2), three row-walk orders each."""
    if mode == "pair":
        args = _k8_args(80, 48, [40, 72], "rt")
    elif mode == "two-pass":
        args = _k8_args(80, 48, [32], two_pass=True)
        assert args[9] is not None
    else:
        args = _k8_args(80, 48, [48], mode)
    want = enc_inter.encode_inter_frame_plain(*args)
    assert _equal(_k8_in_order(args, None), want)
    R, C = want[1].shape[1:3]
    for seed in SEEDS:
        got = _k8_in_order(args, row_order(R, C, enc_inter_cuda.ROW_LAG,
                                           seed))
        assert _equal(got, want), seed


def test_k8_lag_one_breaks_a_scene_cut():
    """The negative control: with lag 1 a macroblock may run before its
    above-right neighbour, whose pixels its B_PRED candidate reads; on a
    scene cut (176x144, most macroblocks intra) some order gives another
    frame."""
    args = _k8_args(176, 144, [48], scene_cut=True)
    want = enc_inter.encode_inter_frame_plain(*args)
    md = want[1]
    assert int((md[..., 2] == 0).sum()) > md[0, ..., 0].numel() // 2
    R, C = md.shape[1:3]
    assert any(not _equal(_k8_in_order(args, row_order(R, C, 1, seed)), want)
               for seed in SEEDS)


# --------------------------------------- the plain K9 in row-walk orders

@pytest.mark.parametrize("qis", [[48], [40, 72]], ids=["one", "pair"])
def test_k9_row_walk_equals_diagonals(qis):
    """80x80 (5 x 5 macroblocks, the search on four), three row-walk
    orders each."""
    args = _k9_args(80, 80, qis)
    want = enc_decide.decide_inter_frame_plain(*args)
    assert torch.equal(_k9_in_order(args, None), want)
    assert (want[..., 0] != 0).any() and (want[..., enc_decide.SITES] > 0).any()
    R, C = want.shape[1:3]
    for seed in SEEDS:
        got = _k9_in_order(args, row_order(R, C, enc_decide_cuda.ROW_LAG,
                                           seed))
        assert torch.equal(got, want), seed


def test_k9_lag_zero_breaks_the_census():
    """The negative control: with lag 0 a macroblock may run before the one
    above it, whose decision its census reads; on a scene cut (176x144)
    some order gives other decisions."""
    args = _k9_args(176, 144, [48], scene_cut=True)
    want = enc_decide.decide_inter_frame_plain(*args)
    R, C = want.shape[1:3]
    assert any(not torch.equal(_k9_in_order(args, row_order(R, C, 0, seed)),
                               want)
               for seed in SEEDS)


# --------------------------------------- the plain K7 in row-walk orders

def _k7_args(w, h, qi, trellis):
    """K7's arguments for frame 0 of a synthetic clip at y_ac_qi ``qi``,
    with the default token costs for the trellis."""
    y, u, v = (torch.from_numpy(np.ascontiguousarray(p))
               for p in gen_clip(w, h, 1, seed=17)[0])
    q = QuantIndices(y_ac_qi=qi).quantizer()
    rm, dm = rd_multipliers(int(q["y_ac"]))
    tc = torch.from_numpy(token_costs_pm(T.DEFAULT_COEFF_PROBS)) \
        if trellis else None
    return y, u, v, [int(q[k]) for k in QUANT_KEYS], rm, dm, tc


def _k7_in_order(args, order):
    return enc_intra.encode_kf_frame_plain(*args, order=order)


@pytest.mark.parametrize("trellis", [False, True], ids=["one-pass", "trellis"])
def test_k7_row_walk_equals_diagonals(trellis):
    """80x48 (3 x 5 macroblocks), one-pass and two-pass (the trellis under
    the default token costs), three row-walk orders each."""
    args = _k7_args(80, 48, 24, trellis)
    want = _k7_in_order(args, None)
    assert (want[1][..., 0] == enc_intra.B_PRED).any()
    for seed in SEEDS:
        got = _k7_in_order(args, row_order(3, 5, enc_intra_cuda.ROW_LAG, seed))
        assert _equal(got, want), seed


@pytest.mark.parametrize("trellis", [False, True], ids=["one-pass", "trellis"])
def test_k7_lag_one_breaks_b_pred(trellis):
    """The negative control: with lag 1 a macroblock may run before its
    above-right neighbour, whose pixels its B_PRED candidate reads; some
    order gives another frame."""
    args = _k7_args(80, 48, 24, trellis)
    want = _k7_in_order(args, None)
    assert any(not _equal(_k7_in_order(args, row_order(3, 5, 1, seed)), want)
               for seed in SEEDS)


# --------------------------------------- the plain K5 in row-walk orders

def _k5_args(key_frame, levels):
    """K5's arguments at 80x48 as the encoder's loop-filter search hands
    them over (its unfiltered reconstruction, broadcast over the levels,
    and its skip map) for a key frame or the interframe after it, with the
    limits of ``levels``."""
    clip = gen_clip(80, 48, 2, seed=29)
    enc = Encoder(80, 48, device="cpu")
    seen = []
    saved = ENC.loop_filter

    def record(y, u, v, lf):
        seen.append((y, u, v, lf))
        return saved(y, u, v, lf)

    ENC.loop_filter = record
    try:
        enc.encode_with_quantizer(clip[0], 24, key_frame=True)
        if not key_frame:
            seen.clear()
            enc.encode_with_quantizer(clip[1], 24)
    finally:
        ENC.loop_filter = saved
    y, u, v, lf = seen[0]
    G = len(levels)
    R, C = lf[0].shape[1:]
    p = loopfilter_params(np.asarray(levels)[:, None, None]
                          + np.zeros((1, R, C), int), 0, key_frame)
    lfp = tuple(torch.from_numpy(p[k]) for k in
                ("level", "interior", "mb_limit", "sb_limit", "hev")) \
        + (lf[5][:1].expand(G, R, C),)
    return tuple(t[:1].expand((G,) + t.shape[1:]) for t in (y, u, v)) + (lfp,)


@pytest.mark.parametrize("frame", ["key", "inter"])
def test_k5_row_walk_equals_diagonals(frame):
    """80x48 (3 x 5 macroblocks): a key frame at one level, and an
    interframe at G = 2 levels, three row-walk orders each."""
    args = _k5_args(frame == "key", [40] if frame == "key" else [20, 63])
    want = loop_filter_plain(*args)
    assert not torch.equal(want[0], args[0])      # the filter changed pixels
    for seed in SEEDS:
        got = loop_filter_plain(*args, order=row_order(3, 5, lf_cuda.ROW_LAG,
                                                       seed))
        assert _equal(got, want), seed


def test_k5_lag_one_breaks_the_filter():
    """The negative control: with lag 1 a macroblock's top edge may be
    filtered before the left edge of its above-right neighbour, which
    writes pixels of the macroblock above that the top edge reads; some
    order gives other planes."""
    args = _k5_args(True, [63])
    want = loop_filter_plain(*args)
    assert any(not _equal(loop_filter_plain(*args,
                                            order=row_order(3, 5, 1, seed)),
                          want)
               for seed in SEEDS)


# --------------------------------------- the plain K1 in row-walk orders

K1_CLIPS = ("inter_176x144_q96.ivf", "inter_176x144_q32.ivf")


@functools.cache
def _k1_args():
    """K1's arguments as the GOP decoder hands them over at G = 2 (the two
    176x144 clips of K1_CLIPS in lockstep, 9 x 11 macroblocks) for frame 0,
    a key frame, and frame 2, an interframe; each frame is decoded through
    the plain K1 for the next one's references."""
    ivfs = [IVFReader(str(REPO / "tests" / "fixtures" / n)) for n in K1_CLIPS]
    dec = gop.BatchedGopDecoder(ivfs[0].width, ivfs[0].height, len(ivfs),
                                device="cpu")
    kept = {}
    for f in range(3):
        key_frame, batch, _flags, _show = dec.parse_frame_batch(
            [i.frame(f) for i in ivfs])
        mega, spec_r, spec_c, _off = gop._pack_merged(batch)
        d = gop._unpack_upload(dec._upload(mega), spec_r + spec_c)
        inp, fls = dec._step_inputs(key_frame, d)
        y, u, v, res_y, res_u, res_v, intra = RT._stage_ab(
            key_frame, inp["coeffs"], inp["qf"], inp["y2_coded"],
            inp["has_nonzero"], inp["ref_sel"], inp["sub_mv"], inp["uv_mv"],
            dec.refs)
        args = (y, u, v, res_y, res_u, res_v, inp["ymode"], inp["uvmode"],
                inp["bmode"], inp["has_nonzero"], intra, inp["lf_params"])
        kept["key" if f == 0 else "inter"] = args
        planes = wavefront_decode_plain(*args)
        dec.refs = {p: gop.update_references(dec.refs[p], r, fls, key_frame)
                    for p, r in zip("yuv", planes)}
    return kept


@pytest.mark.parametrize("frame", ["key", "inter"])
def test_k1_row_walk_equals_diagonals(frame):
    """176x144 at G = 2: a key frame (B_PRED macroblocks, filter levels 4
    and 25) and an interframe with intra macroblocks, three row-walk
    orders each, every macroblock predicted from the unfiltered pixels and
    filtered in the other planes as the kernel does it.  K4's plain
    version (the intra phase alone) on the same frames, in the orders of
    intra_cuda.ROW_LAG, equals its diagonal order too."""
    args = _k1_args()[frame]
    ymode, intra, level = args[6], args[10], args[11][0]
    assert ymode.shape[0] >= 2 and (level > 0).any()
    assert ((ymode == wavefront.B_PRED) & intra).any()
    assert frame == "key" or 0 < int(intra.sum()) < intra.numel() // 2
    want = wavefront_decode_plain(*args)
    want4 = intra_frame_plain(*args[:11])
    G, R, C = ymode.shape
    for seed in SEEDS:
        got = wavefront_decode_plain(
            *args, order=row_order(R, C, wavefront_cuda.ROW_LAG, seed))
        assert _equal(got, want), seed
        got4 = intra_frame_plain(
            *args[:11], order=row_order(R, C, intra_cuda.ROW_LAG, seed))
        assert _equal(got4, want4), seed


def test_k1_lag_one_breaks_the_wavefront():
    """The negative control: with lag 1 a macroblock may run before its
    above-right neighbour, whose unfiltered pixels its prediction reads and
    whose left edge writes pixels its top edge reads; some order gives
    other planes.  The same holds for K4's plain version (its B_PRED
    prediction reads the above-right neighbour's unfiltered pixels)."""
    args = _k1_args()["key"]
    want = wavefront_decode_plain(*args)
    want4 = intra_frame_plain(*args[:11])
    G, R, C = args[6].shape
    assert any(not _equal(wavefront_decode_plain(
        *args, order=row_order(R, C, 1, seed)), want) for seed in SEEDS)
    assert any(not _equal(intra_frame_plain(
        *args[:11], order=row_order(R, C, 1, seed)), want4)
        for seed in SEEDS)


# -------------------------------------- the plain K10 in row-walk orders

def _k10_args(qis):
    """K10's arguments as the fast path hands them over (fast_frame's call,
    recorded) for a scene cut at 176x144 (the _k9_args scene cut: most
    macroblocks intra, many of them neighbours)."""
    clip = gen_clip(176, 144, 3, seed=23)
    key, frame = clip[1], (np.ascontiguousarray(clip[0][0][::-1]),
                           clip[0][1], clip[0][2])
    enc = Encoder(176, 144, device="cpu", quality="rt", fast=True)
    enc.encode_with_quantizer(key, qis[0], key_frame=True)
    args = EF.frame_inputs(enc, frame, [QuantIndices(y_ac_qi=q) for q in qis])
    kept = []
    saved = EF.intra_fixup_frame

    def record(*a):
        kept.append(a)
        return saved(*a)

    EF.intra_fixup_frame = record
    try:
        EF.fast_frame(*args)
    finally:
        EF.intra_fixup_frame = saved
    return kept[0]


@pytest.mark.parametrize("qis", [[48], [40, 72]], ids=["one", "pair"])
def test_k10_row_walk_equals_diagonals(qis):
    """A 176x144 scene cut at one quantizer and the pair, three row-walk
    orders each."""
    args = _k10_args(qis)
    want = intra_fixup_frame_plain(*args)
    intra = args[3][..., 0] == 0
    chained = (intra[:, 1:] & intra[:, :-1]).sum() \
        + (intra[..., 1:] & intra[..., :-1]).sum()
    assert int(chained) > 0 and not bool(intra.all())
    Q, R, C = intra.shape
    for seed in SEEDS:
        got = intra_fixup_frame_plain(
            *args, order=row_order(R, C, enc_intra_fixup_cuda.ROW_LAG, seed))
        assert _equal(got, want), seed


def test_k10_lag_zero_breaks_the_chain():
    """The negative control: with lag 0 an intra macroblock may run before
    the one above it, whose reconstruction it predicts from; some order
    gives another result."""
    args = _k10_args([48])
    want = intra_fixup_frame_plain(*args)
    Q, R, C = args[3].shape[:3]
    assert any(not _equal(intra_fixup_frame_plain(
        *args, order=row_order(R, C, 0, seed)), want) for seed in SEEDS)


# ------------------------- the plain residue update in row-walk orders

def _rebase_args(seed, all_intra=False, width=176, height=144):
    """rebase_frame_plain's arguments (without the reconstruction planes)
    for a seeded frame: random references, originals near LAST.  With
    ``all_intra`` every macroblock is B_PRED with every b-mode B_LD_PRED,
    which reads the four pixels above-right of each sub-block; else about
    60 % are intra, cycling DC, V, H, TM and B_PRED (b-modes random, the
    right-most column's LD or VL, which read above-right) with the chroma
    modes, the rest inter from a random slot, whole-vector or SPLITMV."""
    R, C = height // 16, width // 16
    rng = np.random.default_rng(seed)
    dims = ((height, width), (height // 2, width // 2),
            (height // 2, width // 2))
    refs = [rng.integers(0, 256, (3,) + d, dtype=np.uint8) for d in dims]
    orig = [np.clip(r[0].astype(int) + rng.integers(-40, 41, d), 0, 255)
            .astype(np.uint8) for r, d in zip(refs, dims)]
    ref = rng.integers(1, 4, (R, C))
    ymode = rng.integers(T.NEARESTMV, T.SPLITMV + 1, (R, C))
    intra = np.ones((R, C), bool) if all_intra else rng.random((R, C)) < 0.6
    k = np.cumsum(intra).reshape(R, C)
    ref[intra] = T.CURRENT_FRAME
    ymode[intra] = T.B_PRED if all_intra else (k[intra] % 5)
    uvmode = np.where(intra, k % 4, 0)
    bmode = rng.integers(0, 10, (R, C, 4, 4))
    bmode[..., 3] = rng.choice([T.B_LD_PRED, T.B_VL_PRED], (R, C, 4))
    if all_intra:
        bmode[:] = T.B_LD_PRED
    sub_mv = rng.integers(-64, 65, (R, C, 4, 4, 2))
    whole = ymode != T.SPLITMV
    sub_mv[whole] = sub_mv[whole][:, :1, :1]
    uv_mv = rng.integers(-32, 33, (R, C, 2, 2, 2))
    t = torch.from_numpy
    words = t(rebase.mb_words(ref, ymode, uvmode, bmode, sub_mv, uv_mv))
    q = QuantIndices(y_ac_qi=36).quantizer()
    return ([t(o) for o in orig],
            {p: tuple(t(refs[i])) for i, p in enumerate("yuv")}, words,
            [int(q[k]) for k in QUANT_KEYS])


def _rebase_in_order(args, order):
    """rebase_frame_plain's output words and planes, its intra
    macroblocks walked in ``order``."""
    recon = [torch.zeros_like(o) for o in args[0]]
    return (rebase.rebase_frame_plain(*args, recon, order=order),) \
        + tuple(recon)


def _kernel_lags(words):
    """The wait of each macroblock in the residue kernel: inter ones none,
    intra ones by their mode."""
    intra = (words[..., rebase.W_REF] == 0).numpy()
    bpred = (words[..., rebase.W_YMODE] == T.B_PRED).numpy()
    return np.where(intra, np.where(bpred, rebase_cuda.ROW_LAG_BPRED,
                                    rebase_cuda.ROW_LAG_WHOLE), 0)


def test_rebase_row_walk_equals_raster():
    """The residue update of a 176x144 frame, 60 % intra: its intra
    macroblocks in raster order, in the default diagonals d = 2r + c and in
    three row-walk orders under the kernel's lags by mode give
    torch.equal output words and planes; a B_PRED macroblock reads an
    intra above-right neighbour.  And the decoder's intra step (K4's plain
    version, the 127 / 129 and above-right rules of decoding) rebuilds the
    same planes from the coefficients: the rebase predicts as a decoder
    does."""
    args = _rebase_args(7)
    words = args[2]
    R, C = words.shape[:2]
    intra = words[..., rebase.W_REF] == 0
    bpred = intra & (words[..., rebase.W_YMODE] == T.B_PRED)
    assert bool((bpred[1:, :-1] & intra[:-1, 1:]).any())
    want = _rebase_in_order(args, [([r], [c]) for r in range(R)
                                   for c in range(C)])
    assert _equal(_rebase_in_order(args, None), want)
    lags = _kernel_lags(words)
    for seed in SEEDS:
        assert _equal(_rebase_in_order(args, row_order(R, C, lags, seed)),
                      want), seed

    out, y, u, v = want
    co, nz, y2 = rebase.split_out(out)
    qf = {k: torch.full((R, C), f, dtype=torch.int32)
          for k, f in zip(QUANT_KEYS, args[3])}
    res = transforms.residuals_from_coeffs(co.to(torch.int32), qf, y2)
    as_tile = lambda b, n: b.reshape(R, C, n, n, 4, 4).permute(
        0, 1, 2, 4, 3, 5).reshape(1, R, C, 4 * n, 4 * n).to(torch.int16)
    bmode = torch.stack([(words[..., rebase.W_BMODE + i // 4] >> 8 * (i % 4))
                         & 255 for i in range(16)], -1)
    dec = intra_frame_plain(
        tile(y[None], 16).to(torch.uint8), tile(u[None], 8).to(torch.uint8),
        tile(v[None], 8).to(torch.uint8), as_tile(res[:, :, :16], 4),
        as_tile(res[:, :, 16:20], 2), as_tile(res[:, :, 20:], 2),
        words[None, ..., rebase.W_YMODE], words[None, ..., rebase.W_UVMODE],
        bmode[None].to(torch.uint8), nz[None], intra[None])
    for got, plane in zip(dec, (y, u, v)):
        assert torch.equal(got[0], plane)


def test_rebase_lag_one_breaks_b_pred():
    """The negative control: a frame of B_PRED macroblocks whose sub-blocks
    all read their above-right pixels; at lag 1 a macroblock may run before
    the one above-right of it, and some order gives another result."""
    args = _rebase_args(8, all_intra=True)
    R, C = args[2].shape[:2]
    want = _rebase_in_order(args, None)
    assert any(not _equal(_rebase_in_order(args, row_order(R, C, 1, seed)),
                          want) for seed in SEEDS)


# -------------------------------------------- one source for the chain

CHAIN = ("clamp_mv", "luma_taps", "sixtap_pred", "warp_sum", "census_load",
         "census_decide", "diamond_search", "new_rate", "candidate_sums",
         "decide_candidates")


@pytest.mark.parametrize("name", CHAIN)
def test_decision_chain_defined_once(name):
    """Each function of K8's and K9's decision chain is defined in exactly
    one file under csrc/, the header both kernels include."""
    csrc = REPO / "alfalfa_tpu_torch" / "csrc"
    pat = re.compile(r"__device__[^;{(]*\b%s\s*\(" % name)
    files = [p.name for p in sorted(csrc.iterdir())
             if p.suffix in (".cu", ".cuh") and pat.search(p.read_text())]
    assert files == ["enc_inter_chain.cuh"]
    for kernel in ("enc_inter.cu", "enc_decide.cu"):
        assert '#include "enc_inter_chain.cuh"' in (csrc / kernel).read_text()


@pytest.mark.parametrize("name", ["filter_edge", "lf_line",
                                  "lf_filter_window"])
def test_loop_filter_defined_once(name):
    """The per-macroblock loop filter of K1's and K5's row walks is defined
    once, in csrc/wavefront_device.cuh, and both kernels call
    lf_filter_window."""
    csrc = REPO / "alfalfa_tpu_torch" / "csrc"
    pat = re.compile(r"__device__[^;{(]*\b%s\s*\(" % name)
    files = [p.name for p in sorted(csrc.iterdir())
             if p.suffix in (".cu", ".cuh") and pat.search(p.read_text())]
    assert files == ["wavefront_device.cuh"]
    src = (csrc / "wavefront_device.cuh").read_text()
    for kernel in ("wave_row_kernel", "lf_row_kernel"):
        body = src[src.index(" %s(" % kernel):]
        body = body[:body.index("\n}\n")]
        assert "lf_filter_window(" in body, kernel


def test_reconstruction_step_defined_once():
    """The intra reconstruction step of K1's and K4's row walks (the pixels
    above, the whole-block rows, the B_PRED chain) is defined once, in
    csrc/wavefront_device.cuh, and both kernels call each part."""
    csrc = REPO / "alfalfa_tpu_torch" / "csrc"
    src = (csrc / "wavefront_device.cuh").read_text()
    for name in ("intra_above_load", "intra_mb_rows", "bpred_chain"):
        pat = re.compile(r"__device__[^;{(]*\b%s\s*\(" % name)
        files = [p.name for p in sorted(csrc.iterdir())
                 if p.suffix in (".cu", ".cuh") and pat.search(p.read_text())]
        assert files == ["wavefront_device.cuh"], name
        assert len(pat.findall(src)) == 1, name
        for kernel in ("wave_row_kernel", "intra_row_kernel"):
            body = src[src.index(" %s(" % kernel):]
            body = body[:body.index("\n}\n")]
            assert name + "(" in body, (name, kernel)
