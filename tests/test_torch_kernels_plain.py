"""The plain PyTorch versions of the two CUDA kernels against the TPU
kernels they replace, on the CPU, tolerance 0 (integer arithmetic).

The Pallas kernels run in interpret mode off-TPU (autodetected), exactly as
tests/test_mc_packed.py and tests/test_wavefront_kernel.py run them.  Each
interpret-mode call is made once, inside the one test that needs it: they
are the expensive part, and the other tests do not depend on them.  The CUDA kernels themselves are held against these plain
versions on the card by ``python3 chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)    # many tiny ops: threads only add contention
import jax
import jax.numpy as jnp

from alfalfa_tpu.ops import sixtap_pallas as SP
from alfalfa_tpu.util.ivf import IVFReader
from alfalfa_tpu.bitstream.header import UncompressedChunk
from alfalfa_tpu.decoder.parse import FrameParser
from alfalfa_tpu.decoder.decoder import Decoder
from alfalfa_tpu.decoder import reconstruct_np, reconstruct_jax as RJ

from alfalfa_tpu_torch._build import check_tensor
from alfalfa_tpu_torch.decoder import reconstruct_torch as RT
from alfalfa_tpu_torch.ops import sixtap as TS, sixtap_cuda, wavefront, \
    wavefront_cuda

R, C = 2, 8         # interpret mode costs per macroblock: keep it small
H, W = R * 16, C * 16


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ----------------------------------------------------------- K2: sixtap MC

def _mc_inputs(seed):
    """The extreme-MV cases of tests/test_mc_packed.py on a smaller grid,
    plus one intra macroblock (selector 0)."""
    rng = np.random.RandomState(seed)
    sub_mv = np.repeat(
        rng.randint(-60, 60, (R, C, 1, 1, 2)), 16, axis=2) \
        .reshape(R, C, 4, 4, 2)[:, :, :4, :4]
    sub_mv = np.ascontiguousarray(sub_mv)
    for (r, c) in [(0, 0), (0, 3), (1, 7)]:   # SPLITMV macroblocks
        sub_mv[r, c] = rng.randint(-40, 40, (4, 4, 2))
    # extreme MVs: windows fully outside the frame (edge clamp path)
    sub_mv[1, 1, :, :] = [900, -900]
    sub_mv[1, 2, :, :] = [-2000, 2000]
    sub_mv[0, 4, :, :] = 0                    # zero-MV case
    sub_mv[0, 5, :, :] = [40, -16]            # full-pel nonzero
    sub_mv[0, 6, :, :] = [-896, 896]          # full-pel AND clamped
    sub_mv[0, 7, :, :] = [8, 3]               # x full-pel, y subpel
    sel = rng.randint(1, 4, (R, C))
    sel[0, 1] = 0
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
    want = np.asarray(SP.mc_tiles_packed(
        packed, R * S, C * S, jnp.asarray(sel), jnp.asarray(mv), S))
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


def test_mc_wrapper_checks_and_cpu_route():
    planes, sel, mv = _mc_case(16)
    before = sixtap_cuda.launches
    got = sixtap_cuda.mc_tiles(t(planes)[None], t(sel)[None], t(mv)[None], 16)
    want = TS.mc_tiles_plain(t(planes)[None], t(sel)[None], t(mv)[None], 16)
    assert torch.equal(got, want)
    assert sixtap_cuda.launches == before      # CPU tensor: no launch
    with pytest.raises(TypeError):
        check_tensor("sub_mv", t(mv).to(torch.int64), torch.int32,
                           mv.shape, torch.device("cpu"))
    with pytest.raises(ValueError):
        check_tensor("ref_sel", t(sel).T, torch.int32, sel.T.shape[::-1],
                           torch.device("cpu"))


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
    y, u, v = RJ.reconstruct_core_batch(
        arrays.mb_rows, arrays.mb_cols, G, key_frame,
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


CASES = {"key": ("tests/fixtures/kf_176x144_q16.ivf", 0),       # B_PRED
         "inter": ("tests/fixtures/inter_176x144_q96.ivf", 1)}
G_WAVE = 2


@pytest.mark.parametrize("name", ["key", "inter"])
def test_plain_wavefront_equals_pallas_interpret(name):
    """Exactly one interpret-mode run of the merged TPU wavefront per
    case (a key frame and an interframe, G=2)."""
    inp = _frame_inputs(*CASES[name])
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
