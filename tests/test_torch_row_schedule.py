"""The persistent row walk of K8 and K9 on the CPU, no JAX: the plain
versions driven one macroblock at a time in orders that row walkers under
the progress-flag rule of csrc/row_sched.cuh could produce, with the very
lags the wrappers pass to the card (``enc_inter_cuda.ROW_LAG``,
``enc_decide_cuda.ROW_LAG``), are ``torch.equal`` to the anti-diagonal
order; one lag less gives a different frame on a scene cut, so the rule
is tight and the test can fail.  And the decision chain K8 and K9 share
is defined once under csrc/.
"""
import pathlib
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)    # many tiny ops: threads only add contention

from alfalfa_tpu_torch.bitstream.header import QuantIndices
from alfalfa_tpu_torch.encoder import Encoder
from alfalfa_tpu_torch.encoder import encode_inter as EI
from alfalfa_tpu_torch.encoder import encode_inter_fast as EF
from alfalfa_tpu_torch.ops import enc_batch, enc_decide, enc_decide_cuda, \
    enc_inter, enc_inter_cuda
from alfalfa_tpu_torch.ops.wavefront import diagonals, row_order, tile

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
    """K8 reads up to its above-right neighbour (diagonals 2r + c), K9 its
    left, above and above-left (r + c): the lags the kernels run with are
    those of the diagonals the plain versions walk by default."""
    assert enc_inter_cuda.ROW_LAG == 2 and enc_decide_cuda.ROW_LAG == 1
    for k, lag in ((2, enc_inter_cuda.ROW_LAG), (1, enc_decide_cuda.ROW_LAG)):
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
