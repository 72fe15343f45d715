"""The plain PyTorch versions of the CUDA kernels against the TPU kernels
they replace, on the CPU, tolerance 0 (integer arithmetic):

- K1 ``wavefront_decode_plain`` against wavefront_pm's merged wavefront
  (and K6, wavefront_pallas's lane-major twin, with ALFALFA_PM=0);
- K2 ``mc_tiles_plain`` against sixtap_pallas.mc_tiles_packed;
- K3 ``predict_mb_tiles`` against sixtap_pallas.mc_tiles;
- the three-plane entry's plain version (``mc_planes_plain``, behind both
  wrappers) against those per-plane calls, on the strides and batch forms
  the paths hand it;
- K4 ``intra_frame_plain`` against intra_pallas.intra_frame;
- K5 ``loop_filter_plain`` against lf_pallas.lf_pallas (and the encoders'
  ``loopfilter_tiles`` against reconstruct_jax's on its TPU path).

The Pallas kernels run in interpret mode off-TPU: the GOP kernels
autodetect it, as tests/test_mc_packed.py and tests/test_wavefront_kernel.py
run them; K3, K4 and K5 take no such argument, so their module's ``pl`` is
swapped, for one test, for a proxy whose ``pallas_call`` interprets.  Each
interpret-mode call is made once, under ``jax.jit``, inside the one test
that needs it: they are the expensive part (tracing and compiling the
interpreted kernel), and the grids are a few macroblocks that hold every
case.  The
CUDA kernels themselves are held against these plain versions on the card
by ``python3 chip_smoke.py``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)    # many tiny ops: threads only add contention
import jax
import jax.numpy as jnp

from alfalfa_tpu.ops import intra_pallas, lf_pallas, sixtap_pallas as SP
from alfalfa_tpu.util.ivf import IVFReader
from alfalfa_tpu.bitstream.header import UncompressedChunk
from alfalfa_tpu.decoder.parse import FrameParser
from alfalfa_tpu.decoder.decoder import Decoder
from alfalfa_tpu.decoder import reconstruct_np, reconstruct_jax as RJ
from alfalfa_tpu.decoder.lf_params import loopfilter_params

from alfalfa_tpu_torch._build import check_map, check_tensor
from alfalfa_tpu_torch.decoder import reconstruct_torch as RT
from alfalfa_tpu_torch.ops import intra_cuda, lf_cuda, sixtap as TS, \
    sixtap_cuda, wavefront, wavefront_cuda

R, C = 2, 3         # interpret mode costs per macroblock: keep it small
H, W = R * 16, C * 16


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


class _InterpretPallas:
    """A module's ``pl`` with ``pallas_call`` in interpret mode."""

    def __init__(self, pl):
        self._pl = pl
        self.pallas_call = functools.partial(pl.pallas_call, interpret=True)

    def __getattr__(self, name):
        return getattr(self._pl, name)


def _interpret(monkeypatch, module):
    monkeypatch.setattr(module, "pl", _InterpretPallas(module.pl))


# ----------------------------------------------------------- K2: sixtap MC

def _mc_inputs(seed):
    """The extreme-MV cases of tests/test_mc_packed.py on six macroblocks:
    SPLITMV (with a zero-MV block and a block fully outside the frame among
    its sixteen), selector 0 (intra), a window fully outside the frame,
    full-pel, full-pel and clamped, x full-pel with y sub-pel."""
    rng = np.random.RandomState(seed)
    sub_mv = np.repeat(
        rng.randint(-60, 60, (R, C, 1, 1, 2)), 16, axis=2) \
        .reshape(R, C, 4, 4, 2)
    sub_mv = np.ascontiguousarray(sub_mv)
    sub_mv[0, 0] = rng.randint(-40, 40, (4, 4, 2))    # SPLITMV
    sub_mv[0, 0, 1, 2] = 0                            # ... zero-MV block
    sub_mv[0, 0, 3, 1] = [-2000, 2000]                # ... block fully outside
    sub_mv[0, 2, :, :] = [900, -900]          # window fully outside
    sub_mv[1, 0, :, :] = [40, -16]            # full-pel nonzero
    sub_mv[1, 1, :, :] = [-896, 896]          # full-pel AND clamped
    sub_mv[1, 2, :, :] = [8, 3]               # x full-pel, y subpel
    sel = rng.randint(1, 4, (R, C))
    sel[0, 1] = 0                             # intra: predicted from last
    refs = rng.randint(0, 256, (3, H, W)).astype(np.uint8)
    refs_uv = rng.randint(0, 256, (3, H // 2, W // 2)).astype(np.uint8)
    q = sub_mv.reshape(R, C, 2, 2, 2, 2, 2).sum(axis=(3, 5))
    uv_mv = np.sign(q) * ((np.abs(q) + 4) >> 3)
    return sel.astype(np.int32), sub_mv.astype(np.int32), \
        uv_mv.astype(np.int32), refs, refs_uv


def _mc_case(S):
    sel, sub_mv, uv_mv, refs, refs_uv = _mc_inputs(7)
    return (refs, sel, sub_mv) if S == 16 else (refs_uv, sel, uv_mv)


@pytest.mark.parametrize("S", [16, 8])
def test_plain_mc_equals_pallas_packed(S):
    """One interpret-mode call of the TPU kernel per plane size."""
    planes, sel, mv = _mc_case(S)
    # the TPU layout: slot 0 (intra) is a copy of ``last``
    stack4 = np.concatenate([planes[:1], planes])
    packed = SP.pack_refs32(SP.pad_refs(jnp.asarray(stack4)))
    sel_j, mv_j = jnp.asarray(sel), jnp.asarray(mv)
    # this kernel's interpret-mode program is slow to compile whatever the
    # grid; integer arithmetic gives the same results without XLA's backend
    # optimisations, which compile faster
    want = np.asarray(
        jax.jit(SP.mc_tiles_packed, static_argnums=(1, 2, 5))
        .lower(packed, R * S, C * S, sel_j, mv_j, S)
        .compile({"xla_backend_optimization_level": 0})(packed, sel_j, mv_j))
    got = TS.mc_tiles_plain(t(planes)[None], t(sel)[None], t(mv)[None], S)
    assert got.dtype == torch.uint8 and got.shape == (1, R, C, S, S)
    np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("S", [16, 8])
def test_plain_mc_batch_axis(S):
    """G is a written-out batch axis: GOP g reads only its own references
    and is predicted as the single-frame function predicts it."""
    planes, sel, mv = _mc_case(S)
    rng = np.random.default_rng(S)
    other = rng.integers(0, 256, planes.shape).astype(np.uint8)
    refs = t(np.stack([other, planes]))
    sel2 = t(np.stack([np.roll(sel, 1, axis=1), sel]))
    mv2 = t(np.stack([np.roll(mv, 1, axis=0), mv]))
    got = TS.mc_tiles_plain(refs, sel2, mv2, S)
    for g in range(2):
        one = TS.predict_mb_tiles(refs[g], torch.clamp(sel2[g] - 1, min=0),
                                  mv2[g], S)
        np.testing.assert_array_equal(got[g].numpy(), one.numpy())


def _mc_three(G=1, seed=7):
    """The three planes' _mc_inputs for G frames: {plane: (G, 3, H, W)}
    stacks, and (G, ...) selectors and vectors (frame g > 0 rolled)."""
    sel, sub_mv, uv_mv, refs, refs_uv = _mc_inputs(seed)
    rng = np.random.default_rng(seed)
    frame = lambda a, g: a if g == 0 else np.roll(a, g, axis=0)
    stacks = {"y": refs, "u": refs_uv,
              "v": rng.integers(0, 256, refs_uv.shape).astype(np.uint8)}
    return ({p: t(np.stack([frame(r, g) for g in range(G)]))
             for p, r in stacks.items()},
            t(np.stack([frame(sel, g) for g in range(G)])),
            t(np.stack([frame(sub_mv, g) for g in range(G)])),
            t(np.stack([frame(uv_mv, g) for g in range(G)])))


def _per_plane(stacks, sel, sub_mv, uv_mv):
    """The three planes through the per-plane plain version held to the
    TPU kernels (test_plain_mc_equals_pallas_packed)."""
    return tuple(TS.mc_tiles_plain(stacks[p], sel, mv, S)
                 for p, mv, S in (("y", sub_mv, 16), ("u", uv_mv, 8),
                                  ("v", uv_mv, 8)))


def _planes_equal(got, want, G):
    for a, b, S in zip(got, want, (16, 8, 8)):
        assert a.dtype == torch.uint8 and a.shape == (G, R, C, S, S)
        assert torch.equal(a, b)


def test_mc_wrapper_checks_and_cpu_route():
    """On CPU tensors both wrappers take the plain version of the
    three-plane entry and count no launch, and it equals the per-plane
    plain calls held to the TPU kernels above in each form a path hands it
    over: mc_tiles at G=2 on (G, 3, H, W) stacks (the GOP decoder);
    predict_mb_tiles on three separate slot planes a plane at G=1 (the
    single-frame decoder's rasters), on one (H, W) LAST a plane under Q=2
    vector sets with no selectors (the fast path; it must read slot 0
    alone), and with one vector a macroblock as a stride-0 view over its
    blocks (the fast path's).  The checks of the kernel's arguments raise
    on what it does not take: wrong dtypes, shapes, strides, slot counts
    and alignment."""
    stacks, sel, sub_mv, uv_mv = _mc_three(G=2)
    before = (sixtap_cuda.launches, sixtap_cuda.kernel_launches,
              sixtap_cuda.predict_launches)
    got = sixtap_cuda.mc_tiles(stacks, sel, sub_mv, uv_mv)
    _planes_equal(got, _per_plane(stacks, sel, sub_mv, uv_mv), 2)
    slots = {p: tuple(stacks[p][:, k] for k in range(3)) for p in "yuv"}
    _planes_equal(sixtap_cuda.predict_mb_tiles(slots, sel, sub_mv, uv_mv),
                  got, 2)
    # one frame's three separate rasters
    one = {p: tuple(stacks[p][0, k].clone() for k in range(3)) for p in "yuv"}
    _planes_equal(sixtap_cuda.predict_mb_tiles(one, sel[:1], sub_mv[:1],
                                               uv_mv[:1]),
                  _per_plane({p: x[:1] for p, x in stacks.items()}, sel[:1],
                             sub_mv[:1], uv_mv[:1]), 1)
    # LAST alone under two vector sets; slots 1 and 2 of the reference
    # hold other pixels, so a read of them would show
    last = {p: stacks[p][0, 0].clone() for p in "yuv"}
    want = _per_plane(
        {p: torch.stack([x, stacks[p][1, 1], stacks[p][1, 2]])[None]
         .expand(2, 3, *x.shape) for p, x in last.items()},
        torch.ones_like(sel), sub_mv, uv_mv)
    _planes_equal(sixtap_cuda.predict_mb_tiles(
        {p: (x,) for p, x in last.items()}, None, sub_mv, uv_mv), want, 2)
    # one vector a macroblock, expanded over its blocks
    per_mb = lambda mv, n: mv[:, :, :, :1, :1].expand(mv.shape[:3] + (n, n, 2))
    ex_y, ex_c = per_mb(sub_mv, 4), per_mb(uv_mv, 2)
    assert ex_y.stride()[3:5] == (0, 0)
    _planes_equal(sixtap_cuda.predict_mb_tiles(slots, sel, ex_y, ex_c),
                  _per_plane(stacks, sel, ex_y.contiguous(),
                             ex_c.contiguous()), 2)
    assert (sixtap_cuda.launches, sixtap_cuda.kernel_launches,
            sixtap_cuda.predict_launches) == before   # no launch

    def rejects(exc, **change):
        a = dict(refs=slots, ref_sel=sel, sub_mv=sub_mv, uv_mv=uv_mv)
        a.update(change)
        with pytest.raises(exc):
            sixtap_cuda._mc_planes("test", a["refs"], a["ref_sel"],
                                   a["sub_mv"], a["uv_mv"])
    rejects(TypeError, sub_mv=sub_mv.to(torch.int64))
    rejects(TypeError, uv_mv=uv_mv[:, :1])                 # wrong shape
    rejects(ValueError, sub_mv=sub_mv.transpose(3, 4))     # block strides
    rejects(ValueError, ref_sel=sel.to(torch.int64))
    rejects(ValueError, ref_sel=sel.transpose(1, 2).contiguous()
            .transpose(1, 2))                              # not contiguous
    rejects(TypeError, refs=dict(slots, y=tuple(x.to(torch.int16)
                                                for x in slots["y"])))
    rejects(ValueError, refs=dict(slots, u=slots["u"][:2]))  # two slots
    rejects(ValueError, refs=dict(slots, v=tuple(x[:, :-1] for x in
                                                 slots["v"])))  # shape
    G_, H_, W_ = slots["y"][0].shape
    wide = torch.zeros((G_, H_, W_ + 8), dtype=torch.uint8)[..., :W_]
    rejects(ValueError, refs=dict(slots, y=(wide,) * 3))   # row stride
    odd = torch.zeros(stacks["u"][:, 0].numel() + 1, dtype=torch.uint8)
    odd = odd[1:].view(stacks["u"][:, 0].shape)            # 1 byte off
    rejects(ValueError, refs=dict(slots, u=(odd,) * 3))
    with pytest.raises(TypeError):
        check_tensor("sub_mv", sub_mv.to(torch.int64), torch.int32,
                     sub_mv.shape, torch.device("cpu"))


# --------------------------------------------------- K1: decode wavefront

def _frame_inputs(path, frame_no):
    ivf = IVFReader(path)
    dec = Decoder(ivf.width, ivf.height)
    for i in range(frame_no):
        dec.decode_frame(ivf.frame(i))
    refs = dec.references
    chunk = UncompressedChunk(ivf.frame(frame_no), ivf.width, ivf.height)
    header, arrays, _ = FrameParser(dec.state).parse(chunk)
    want = reconstruct_np.reconstruct(header, arrays, dec.state, refs,
                                      chunk.key_frame)
    qf = RJ._frame_quant_factors(header, dec.state, arrays.segment)
    lfp = RJ._frame_lf_params(header, arrays, dec.state, chunk.key_frame)
    return chunk.key_frame, arrays, refs, qf, lfp, want


def _jax_batch(key_frame, arrays, refs, qf, lfp, G):
    """reconstruct_core_batch as tests/test_wavefront_kernel.py drives it:
    the merged Pallas wavefront in interpret mode."""
    def rep(x):
        return np.broadcast_to(np.asarray(x)[None], (G,) + np.shape(x)).copy()

    stack = lambda p: rep(np.stack([getattr(refs.last, p),
                                    getattr(refs.last, p),
                                    getattr(refs.golden, p),
                                    getattr(refs.alternative, p)]))
    # one jit around the whole call (a fresh function, so no trace is
    # shared between tests): its interpret-mode kernel traces far faster
    # than op by op
    y, u, v = jax.jit(lambda *a: RJ.reconstruct_core_batch(
        arrays.mb_rows, arrays.mb_cols, G, key_frame, *a))(
        jnp.asarray(rep(arrays.coeffs.astype(np.int32))),
        {k: jnp.asarray(rep(qa)) for k, qa in qf.items()},
        jnp.asarray(rep(arrays.y2_coded)),
        jnp.asarray(rep(arrays.has_nonzero)),
        jnp.asarray(rep(arrays.ymode.astype(np.int32))),
        jnp.asarray(rep(arrays.uvmode.astype(np.int32))),
        jnp.asarray(rep(arrays.bmode.astype(np.int32))),
        jnp.asarray(rep(arrays.ref.astype(np.int32))),
        jnp.asarray(rep(arrays.sub_mv.astype(np.int32))),
        jnp.asarray(rep(arrays.uv_mv.astype(np.int32))),
        jnp.asarray(stack("y")), jnp.asarray(stack("u")),
        jnp.asarray(stack("v")),
        tuple(jnp.asarray(rep(x)) for x in lfp))
    return np.asarray(y), np.asarray(u), np.asarray(v)


def _torch_batch(key_frame, arrays, refs, qf, lfp, G):
    """The port's reconstruct_core_batch on the same arrays: stage A/B
    then the plain wavefront (CPU tensors take the plain versions)."""
    def rep(x, dtype=None):
        a = np.broadcast_to(np.asarray(x)[None], (G,) + np.shape(x)).copy()
        out = t(a)
        return out if dtype is None else out.to(dtype)

    R_, C_ = arrays.mb_rows, arrays.mb_cols
    tr = {p: rep(np.stack([getattr(refs.last, p), getattr(refs.golden, p),
                           getattr(refs.alternative, p)]))
          for p in "yuv"}
    return RT.reconstruct_core_batch(
        key_frame, rep(arrays.coeffs, torch.int16),
        {k: rep(qa, torch.int32) for k, qa in qf.items()},
        rep(arrays.y2_coded), rep(arrays.has_nonzero),
        rep(arrays.ymode, torch.int32), rep(arrays.uvmode, torch.int32),
        rep(arrays.bmode.reshape(R_, C_, 16), torch.uint8),
        rep(arrays.ref, torch.int32), rep(arrays.sub_mv, torch.int32),
        rep(arrays.uv_mv, torch.int32), tr,
        tuple(rep(x) for x in lfp))


CASES = {"key": ("tests/fixtures/kf_64x48_q40.ivf", 0),     # 11 B_PRED MBs
         "inter": ("tests/fixtures/inter_176x144_q96.ivf", 1)}
G_WAVE = 2


@pytest.mark.parametrize("name", ["key", "inter"])
def test_plain_wavefront_equals_pallas_interpret(name):
    """Exactly one interpret-mode run of the merged TPU wavefront per
    case (a key frame and an interframe, G=2)."""
    inp = _frame_inputs(*CASES[name])
    if name == "key":
        assert (inp[1].ymode == 4).sum() > 0          # B_PRED is covered
    jax_planes = _jax_batch(*inp[:5], G_WAVE)
    torch_planes = _torch_batch(*inp[:5], G_WAVE)
    for plane, a, b in zip("yuv", torch_planes, jax_planes):
        assert a.dtype == torch.uint8
        np.testing.assert_array_equal(a.numpy(), b, plane)


@pytest.mark.parametrize("name", ["key", "inter"])
def test_plain_wavefront_equals_numpy_oracle(name):
    inp = _frame_inputs(*CASES[name])
    torch_planes = _torch_batch(*inp[:5], G_WAVE)
    want = inp[5]
    for g in range(G_WAVE):
        np.testing.assert_array_equal(torch_planes[0][g].numpy(), want.y)
        np.testing.assert_array_equal(torch_planes[1][g].numpy(), want.u)
        np.testing.assert_array_equal(torch_planes[2][g].numpy(), want.v)


def test_diagonals_cover_every_macroblock_in_dependency_order():
    for R_, C_ in ((1, 1), (1, 7), (5, 1), (9, 11), (45, 80)):
        diags = wavefront.diagonals(R_, C_)
        assert len(diags) == 2 * (R_ - 1) + C_
        seen = {}
        for d, (rs, cs) in enumerate(diags):
            for r, c in zip(rs, cs):
                assert 0 <= r < R_ and 0 <= c < C_ and 2 * r + c == d
                assert (r, c) not in seen
                seen[(r, c)] = d
        assert len(seen) == R_ * C_
        for (r, c), d in seen.items():     # left, above, above-right first
            for nb in ((r, c - 1), (r - 1, c), (r - 1, c + 1), (r - 1, c - 1)):
                if nb in seen:
                    assert seen[nb] < d


def test_wavefront_wrapper_cpu_route_and_param_words():
    """A CPU tensor takes the plain version (no launch counted); the
    per-macroblock words the kernels read are packed as documented."""
    rng = np.random.default_rng(5)
    G, R_, C_ = 2, 2, 3
    u8 = lambda *s: t(rng.integers(0, 256, s).astype(np.uint8))
    i16 = lambda *s: t(rng.integers(-80, 80, s).astype(np.int16))
    ymode = t(rng.integers(0, 5, (G, R_, C_)).astype(np.int32))
    uvmode = t(rng.integers(0, 4, (G, R_, C_)).astype(np.int32))
    bmode = t(rng.integers(0, 10, (G, R_, C_, 16)).astype(np.uint8))
    nz = t(rng.random((G, R_, C_)) < 0.7)
    intra = t(rng.random((G, R_, C_)) < 0.6)
    fl = rng.integers(0, 64, (G, R_, C_)).astype(np.int32)
    lfp = (t(fl), t(np.maximum(fl >> 1, 1)), t((fl + 2) * 2 + 1), t(fl * 2 + 1),
           t(rng.integers(0, 3, (G, R_, C_)).astype(np.int32)),
           t(rng.random((G, R_, C_)) < 0.3))
    args = (u8(G, R_, C_, 16, 16), u8(G, R_, C_, 8, 8), u8(G, R_, C_, 8, 8),
            i16(G, R_, C_, 16, 16), i16(G, R_, C_, 8, 8), i16(G, R_, C_, 8, 8),
            ymode, uvmode, bmode, nz, intra, lfp)
    before = wavefront_cuda.launches
    got = wavefront_cuda.wavefront_decode(*args)
    want = wavefront.wavefront_decode_plain(*args)
    assert wavefront_cuda.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[0].shape == (G, R_ * 16, C_ * 16)
    mbp = wavefront_cuda.pack_mb_params(ymode, uvmode, nz, intra, lfp)
    assert mbp.shape == (G, R_, C_, wavefront_cuda.NP)
    assert mbp.dtype == torch.int16 and mbp.is_contiguous()
    assert torch.equal(mbp[..., 0], ymode.to(torch.int16))
    assert torch.equal(mbp[..., 3], intra.to(torch.int16))
    assert torch.equal(mbp[..., 4], lfp[0].to(torch.int16))
    assert torch.equal(mbp[..., 9], lfp[5].to(torch.int16))


def test_plain_wavefront_equals_lane_major_pallas(monkeypatch):
    """K6: the lane-major twin of the merged TPU wavefront
    (ALFALFA_PM=0, wavefront_pallas.wavefront_frame_batch, interpret mode)
    computes what K1's plain version computes: one B_PRED key frame, G=1."""
    monkeypatch.setenv("ALFALFA_PM", "0")
    inp = _frame_inputs(*CASES["key"])
    jax_planes = _jax_batch(*inp[:5], 1)
    torch_planes = _torch_batch(*inp[:5], 1)
    for plane, a, b in zip("yuv", torch_planes, jax_planes):
        np.testing.assert_array_equal(a.numpy(), b, plane)


# ------------------------------------------ K3: single-frame sixtap MC

@pytest.mark.parametrize("S", [16, 8])
def test_plain_predict_mb_tiles_equals_pallas_mc_tiles(S, monkeypatch):
    """The single-frame TPU kernel on its padded 4-slot stack (slot 0, the
    intra dummy, a copy of ``last``) against the port's plain version on
    the three slot planes, through the wrapper's CPU route (its plane S of
    the three it predicts)."""
    planes, sel, mv = _mc_case(S)
    _interpret(monkeypatch, SP)
    stack4 = np.concatenate([planes[:1], planes])
    want = np.asarray(jax.jit(SP.mc_tiles, static_argnums=(1, 2, 5))(
        SP.pad_refs(jnp.asarray(stack4)), R * S, C * S, jnp.asarray(sel),
        jnp.asarray(mv), S))
    stacks, _, sub_mv, uv_mv = _mc_three()
    slots = {p: tuple(stacks[p][0, k] for k in range(3)) for p in "yuv"}
    slots["y" if S == 16 else "u"] = tuple(t(planes))
    got = sixtap_cuda.predict_mb_tiles(slots, t(sel)[None], sub_mv,
                                       uv_mv)[0 if S == 16 else 1]
    assert got.dtype == torch.uint8 and got.shape == (1, R, C, S, S)
    np.testing.assert_array_equal(got[0].numpy(), want)


# ----------------------------------------------- K4: intra wavefront

RI, CI = 3, 4       # K4 / K5 grid


def _intra_inputs(seed):
    """Stage-A/B output of the JAX package for a seeded interframe of
    3 x 4 macroblocks: three inter, nine intra macroblocks holding every
    ymode (B_PRED twice) and every uvmode, all ten sub-block modes, and
    residuals on and off."""
    rng = np.random.default_rng(seed)
    n = RI * CI
    ymode = (np.arange(n) % 5).reshape(RI, CI).astype(np.int32)
    uvmode = (np.arange(n) % 4).reshape(RI, CI).astype(np.int32)
    bmode = rng.integers(0, 10, (RI, CI, 16)).astype(np.int32)
    bmode.reshape(n, 16)[4] = np.arange(16) % 10     # a B_PRED MB: all ten
    ref_sel = np.zeros((RI, CI), np.int32)
    ref_sel.reshape(n)[[5, 10, 11]] = [1, 2, 3]      # inter macroblocks
    has_nonzero = rng.random((RI, CI)) < 0.6
    coeffs = rng.integers(-24, 25, (RI, CI, 25, 16)).astype(np.int32)
    qf = {k: rng.integers(4, 40, (RI, CI)).astype(np.int32)
          for k in ("y_dc", "y_ac", "y2_dc", "y2_ac", "uv_dc", "uv_ac")}
    y2_coded = (ymode != 4) & (rng.random((RI, CI)) < 0.7)
    sub_mv = rng.integers(-40, 40, (RI, CI, 4, 4, 2)).astype(np.int32)
    uv_mv = rng.integers(-20, 20, (RI, CI, 2, 2, 2)).astype(np.int32)
    refs = [rng.integers(0, 256, (4, RI * S, CI * S)).astype(np.uint8)
            for S in (16, 8, 8)]
    ab = jax.jit(RJ._stage_ab, static_argnums=(0, 1, 2))(
        RI, CI, False, jnp.asarray(coeffs),
                      {k: jnp.asarray(q) for k, q in qf.items()},
                      jnp.asarray(y2_coded), jnp.asarray(has_nonzero),
                      jnp.asarray(ref_sel), jnp.asarray(sub_mv),
                      jnp.asarray(uv_mv), *(jnp.asarray(r) for r in refs))
    return ab, dict(ymode=ymode, uvmode=uvmode, bmode=bmode,
                    has_nonzero=has_nonzero)


def _skew_tools(R_, C_):
    sched = RJ.skew_schedule(R_, C_)
    nd, L = sched["n_diags"], sched["R_pad"]
    scat = jnp.asarray(sched["scat_idx"])
    skew = lambda x: RJ._skew(x, scat, nd, L)

    def unskew_planes(D, S):
        """Skewed (DPAD + nd, L, S*S) storage -> the (H, W) plane."""
        tiles = np.asarray(RJ._unskew(D, jnp.asarray(sched["unskew_idx"]),
                                      R_, C_, (S, S)))
        return tiles.transpose(0, 2, 1, 3).reshape(R_ * S, C_ * S)
    return sched, skew, unskew_planes


def test_plain_intra_frame_equals_pallas_intra_frame(monkeypatch):
    (y_t, u_t, v_t, res_y, res_u, res_v, res, intra_mask), m = \
        _intra_inputs(21)
    sched, skew, unskew_planes = _skew_tools(RI, CI)
    nd, L = sched["n_diags"], sched["R_pad"]
    strip = lambda x: x[RJ.DPAD:]
    i16s = lambda x: strip(skew(jnp.asarray(x))).astype(jnp.int16)
    masks = [jnp.asarray(sched[k]).astype(jnp.int16)
             for k in ("valid", "has_row", "has_col", "last_col")]
    head = jnp.stack([i16s(m["ymode"]), i16s(m["uvmode"]),
                      i16s(m["has_nonzero"]), i16s(intra_mask)] + masks,
                     axis=-1)
    prm = jnp.concatenate([head, i16s(m["bmode"]),
                           jnp.zeros((nd, L, 8), jnp.int16)], axis=-1)
    _interpret(monkeypatch, intra_pallas)
    outs = jax.jit(intra_pallas.intra_frame)(
        i16s(y_t), i16s(u_t), i16s(v_t), prm,
        i16s(res_y.reshape(RI, CI, 256)),
        i16s(res[:, :, 0:16].reshape(RI, CI, 256)),
        i16s(res_u.reshape(RI, CI, 64)), i16s(res_v.reshape(RI, CI, 64)))
    pad = lambda b: jnp.concatenate(
        [jnp.zeros((RJ.DPAD,) + b.shape[1:], b.dtype), b])
    want = [unskew_planes(pad(b), S) for b, S in zip(outs, (16, 8, 8))]

    one = lambda x, dt: t(np.array(x))[None].to(dt)
    got = intra_cuda.intra_frame(
        one(y_t, torch.uint8), one(u_t, torch.uint8), one(v_t, torch.uint8),
        one(res_y, torch.int16), one(res_u, torch.int16),
        one(res_v, torch.int16), one(m["ymode"], torch.int32),
        one(m["uvmode"], torch.int32), one(m["bmode"], torch.uint8),
        one(m["has_nonzero"], torch.bool), one(intra_mask, torch.bool))
    for plane, a, b in zip("yuv", got, want):
        assert a.dtype == torch.uint8 and a.shape == (1,) + b.shape
        np.testing.assert_array_equal(a[0].numpy(), b, plane)


# --------------------------------------------------- K5: loop filter

def _lf_inputs(seed):
    """Seeded 3 x 4-macroblock planes with steps at the 4x4 block edges
    (so the filters' masks pass), and per-MB limits: some macroblocks at
    level 0, some skipping their sub-block edges."""
    rng = np.random.default_rng(seed)

    def plane(S):
        steps = rng.integers(0, 14, (RI * S // 4, CI * S // 4))
        img = 110 + np.kron(steps, np.ones((4, 4), np.int64)) \
            + rng.integers(0, 3, (RI * S, CI * S))
        return img.astype(np.uint8)
    level = rng.integers(8, 64, (RI, CI))
    level[0, 1] = level[2, 2] = 0
    p = loopfilter_params(level, 0, False)
    skip_sb = rng.random((RI, CI)) < 0.4
    lfp = (np.where(level > 0, p["level"], 0).astype(np.int32),
           p["interior"].astype(np.int32), p["mb_limit"].astype(np.int32),
           p["sb_limit"].astype(np.int32), p["hev"].astype(np.int32),
           skip_sb)
    return [plane(16), plane(8), plane(8)], lfp


def _lf_prm(sched, skew, lfp):
    """lf_pallas's per-MB words, as reconstruct_jax._finish packs them."""
    strip = lambda x: x[RJ.DPAD:]
    sk = lambda x: strip(skew(jnp.asarray(x)))
    valid = jnp.asarray(sched["valid"])
    apply_f = valid & (sk(lfp[0]) > 0)
    return jnp.stack([
        apply_f.astype(jnp.int16), sk(lfp[1]).astype(jnp.int16),
        sk(lfp[2]).astype(jnp.int16), sk(lfp[3]).astype(jnp.int16),
        sk(lfp[4]).astype(jnp.int16),
        (apply_f & ~sk(lfp[5])).astype(jnp.int16),
        (apply_f & jnp.asarray(sched["has_col"])).astype(jnp.int16),
        (apply_f & jnp.asarray(sched["has_row"])).astype(jnp.int16)],
        axis=-1)


def _tiles(plane, S):
    return plane.reshape(RI, S, CI, S).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("S", [16, 8])
def test_plain_loop_filter_equals_pallas_lf(S, monkeypatch):
    planes, lfp = _lf_inputs(30 + S)
    sched, skew, unskew_planes = _skew_tools(RI, CI)
    k = 0 if S == 16 else 1
    D = skew(jnp.asarray(_tiles(planes[k], S)).astype(jnp.int16))
    _interpret(monkeypatch, lf_pallas)
    want = unskew_planes(jax.jit(lf_pallas.lf_pallas, static_argnums=2)(
        D, _lf_prm(sched, skew, lfp), S), S)
    ins = [t(p)[None] for p in planes]
    got = lf_cuda.loop_filter(*ins, tuple(t(x)[None] for x in lfp))
    assert np.count_nonzero(want != planes[k]) > 50       # filters did act
    np.testing.assert_array_equal(got[k][0].numpy(), want)
    for a, p in zip(ins, planes):                         # inputs untouched
        np.testing.assert_array_equal(a[0].numpy(), p)


def test_loopfilter_tiles_equals_jax_tpu_path(monkeypatch):
    """The encoders' entry: the port's loopfilter_tiles against
    reconstruct_jax.loopfilter_tiles on its TPU path (three lf_pallas
    calls, interpret mode)."""
    planes, lfp = _lf_inputs(40)
    tiles = [_tiles(p, S) for p, S in zip(planes, (16, 8, 8))]
    _interpret(monkeypatch, lf_pallas)
    want = jax.jit(lambda *a: RJ.loopfilter_tiles(*a, RI, CI, on_tpu=True))(
        *(jnp.asarray(x.reshape(RI, CI, -1)).astype(jnp.int32) for x in tiles),
        tuple(jnp.asarray(x) for x in lfp))
    got = RT.loopfilter_tiles(*(t(x) for x in tiles),
                              tuple(t(x) for x in lfp))
    for plane, a, b in zip("yuv", got, want):
        assert a.dtype == torch.uint8
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), plane)


# ------------------------------------------------------------ wrappers

def test_frame_wrappers_cpu_route_and_checks():
    """On CPU tensors intra_frame, loop_filter and predict_mb_tiles take
    their plain versions and count no launch; the argument checks
    raise."""
    before = (intra_cuda.launches, lf_cuda.launches,
              sixtap_cuda.predict_launches, sixtap_cuda.launches)
    stacks, sel, sub_mv, uv_mv = _mc_three()
    slots = {p: tuple(stacks[p][0, k] for k in range(3)) for p in "yuv"}
    for a, b in zip(sixtap_cuda.predict_mb_tiles(slots, sel, sub_mv, uv_mv),
                    _per_plane(stacks, sel, sub_mv, uv_mv)):
        assert torch.equal(a, b)
    lf_planes, lfp = _lf_inputs(3)
    args = [t(p)[None] for p in lf_planes], tuple(t(x)[None] for x in lfp)
    for a, b in zip(lf_cuda.loop_filter(*args[0], args[1]),
                    wavefront.loop_filter_plain(*args[0], args[1])):
        assert torch.equal(a, b)
    rng = np.random.default_rng(5)
    G, R_, C_ = 1, 2, 3
    tiles = [t(rng.integers(0, 256, (G, R_, C_, S, S)).astype(np.uint8))
             for S in (16, 8, 8)]
    res = [t(rng.integers(-60, 60, (G, R_, C_, S, S)).astype(np.int16))
           for S in (16, 8, 8)]
    maps = (t(rng.integers(0, 5, (G, R_, C_)).astype(np.int32)),
            t(rng.integers(0, 4, (G, R_, C_)).astype(np.int32)),
            t(rng.integers(0, 10, (G, R_, C_, 16)).astype(np.uint8)),
            t(rng.random((G, R_, C_)) < 0.5), t(rng.random((G, R_, C_)) < 0.5))
    for a, b in zip(intra_cuda.intra_frame(*tiles, *res, *maps),
                    wavefront.intra_frame_plain(*tiles, *res, *maps)):
        assert torch.equal(a, b)
    assert (intra_cuda.launches, lf_cuda.launches,
            sixtap_cuda.predict_launches, sixtap_cuda.launches) == before

    cpu = torch.device("cpu")
    with pytest.raises(TypeError):          # residual of the wrong type
        wavefront_cuda.check_wave_inputs(cpu, G, R_, C_, *tiles,
                                         res[0].to(torch.int32), *res[1:],
                                         maps[2], {})
    with pytest.raises(ValueError):         # a map of the wrong shape
        check_map("ymode", maps[0][0], (G, R_, C_), cpu)
    with pytest.raises(ValueError):         # planes of the wrong size
        sixtap_cuda._mc_planes("predict_mb_tiles",
                               dict(slots, y=slots["u"]), sel, sub_mv,
                               uv_mv)
    words = wavefront_cuda.pack_mb_params(lf_params=args[1])
    assert words.shape == (1, RI, CI, wavefront_cuda.NP)
    assert not words[..., :4].any()
    assert torch.equal(words[..., 9], args[1][5].to(torch.int16))
