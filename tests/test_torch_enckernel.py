"""The port's native encode kernels (native/enckernel.cc) on the CPU,
tolerance 0: ``subtract_fdct``, ``quantize`` and ``idct_add`` against their
numpy bodies (the plain versions) and the JAX package's ``enckernel``, on
seeded blocks with planes at 0 and 255, quantizer factors 4-157 and the
int16 extremes; and the rebase's intra macroblock (``_apply_intra_mb``,
B_PRED and whole-block) through the C functions and through the numpy
bodies, coefficients and planes equal; a library that fails to build
raises (no fallback to the numpy bodies).
"""
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from alfalfa_tpu.native import enckernel as jenckernel   # noqa: E402

from alfalfa_tpu_torch.bitstream import tables as T      # noqa: E402
from alfalfa_tpu_torch.bitstream.header import QuantIndices  # noqa: E402
from alfalfa_tpu_torch.decoder import reconstruct_np as RNP  # noqa: E402
from alfalfa_tpu_torch.decoder.parse import FrameArrays  # noqa: E402
from alfalfa_tpu_torch.encoder import reencode as RB     # noqa: E402
from alfalfa_tpu_torch.encoder import transforms_np as FX  # noqa: E402
from alfalfa_tpu_torch.native import enckernel           # noqa: E402
from alfalfa_tpu_torch.state.decoder_state import Raster  # noqa: E402


def _blocks(rng, n):
    """n (4, 4) uint8 blocks: random, flat 0, flat 255, and 0/255 edges."""
    out = [rng.randint(0, 256, (4, 4)).astype(np.uint8) for _ in range(n)]
    out += [np.zeros((4, 4), np.uint8), np.full((4, 4), 255, np.uint8),
            np.tile(np.array([0, 255, 0, 255], np.uint8), (4, 1)),
            np.eye(4, dtype=np.uint8) * 255]
    return out


def _coeffs(rng, n):
    """n int16[16] coefficient blocks: random over the whole int16 range,
    small, and the extremes."""
    out = [rng.randint(-32768, 32768, 16).astype(np.int16) for _ in range(n)]
    out += [rng.randint(-64, 65, 16).astype(np.int16) for _ in range(n)]
    out += [np.full(16, -32768, np.int16), np.full(16, 32767, np.int16),
            np.array([-32768, 32767] * 8, np.int16), np.zeros(16, np.int16)]
    return out


def test_enckernel_matches_plain_and_jax(monkeypatch, tmp_path):
    assert jenckernel.available()
    rng = np.random.RandomState(12)
    blocks = _blocks(rng, 200)
    for _ in range(400):
        a, b = (blocks[i] for i in rng.randint(0, len(blocks), 2))
        # strided rows: blocks inside a wider plane, as the rebase passes
        plane = rng.randint(0, 256, (8, 24)).astype(np.uint8)
        plane[2:6, 5:9] = a
        view = plane[2:6, 5:9]
        got = enckernel.subtract_fdct(view, b)
        assert np.array_equal(got, FX.subtract_fdct_plain(a, b))
        assert np.array_equal(got, jenckernel.subtract_fdct(a, b))
        assert np.array_equal(FX.subtract_fdct(view, b), got)

    factors = [4, 5, 7, 8, 19, 64, 100, 127, 156, 157]
    for co in _coeffs(rng, 60):
        for dc in factors:
            ac = factors[rng.randint(len(factors))]
            got = enckernel.quantize(co, dc, ac)
            assert np.array_equal(got, FX.quantize_plain(co, dc, ac))
            assert np.array_equal(got, jenckernel.quantize(co, dc, ac))
            assert np.array_equal(FX.quantize(co, dc, ac), got)

    for co in _coeffs(rng, 100):
        base = blocks[rng.randint(len(blocks))]
        planes = [np.zeros((8, 12), np.uint8) for _ in range(4)]
        for p in planes:
            p[3:7, 6:10] = base
        enckernel.idct_add(co, planes[0][3:7, 6:10])
        RNP.idct_add_plain(co, planes[1][3:7, 6:10])
        jenckernel.idct_add(co, planes[2][3:7, 6:10])
        RNP.idct_add(co, planes[3][3:7, 6:10])
        for p in planes[1:]:
            assert np.array_equal(p, planes[0])

    for qi in (0, 48, 127):
        _intra_mb_c_equals_numpy(qi, monkeypatch)

    # no quiet fallback: a library that does not build raises
    broken = tmp_path / "enckernel.cc"
    broken.write_text("this is not C++\n")
    with monkeypatch.context() as m:
        m.setattr(enckernel, "_SRC", str(broken))
        m.setattr(enckernel, "_lib", None)
        with pytest.raises(subprocess.CalledProcessError):
            FX.subtract_fdct(blocks[0], blocks[1])


def _numpy_bodies(monkeypatch):
    monkeypatch.setattr(FX, "subtract_fdct", FX.subtract_fdct_plain)
    monkeypatch.setattr(FX, "quantize", FX.quantize_plain)
    monkeypatch.setattr(RNP, "idct_add", RNP.idct_add_plain)


def _intra_mb_c_equals_numpy(qi, monkeypatch):
    """One B_PRED and one whole-block (TM_PRED luma, DC chroma) macroblock
    of a 48x48 frame, beside and below already reconstructed pixels,
    re-applied by ``_apply_intra_mb`` through the C functions and through
    the numpy bodies: coefficients and reconstruction planes equal."""
    rng = np.random.RandomState(qi + 5)
    w, h = 48, 48
    orig = tuple(rng.randint(0, 256, s).astype(np.uint8)
                 for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
    recon0 = tuple(rng.randint(0, 256, p.shape).astype(np.uint8)
                   for p in orig)
    arrays = FrameArrays(3, 3)
    arrays.ymode[1, 1], arrays.uvmode[1, 1] = T.B_PRED, T.V_PRED
    arrays.bmode[1, 1] = rng.randint(0, 10, (4, 4))
    arrays.ymode[1, 2], arrays.uvmode[1, 2] = T.TM_PRED, T.DC_PRED
    q = {k: int(v) for k, v in QuantIndices(y_ac_qi=qi).quantizer().items()}

    def rebuild():
        a = FrameArrays(3, 3)
        for f in ("ymode", "uvmode", "bmode"):
            getattr(a, f)[:] = getattr(arrays, f)
        recon = Raster(w, h, *(p.copy() for p in recon0))
        for r, c in ((1, 1), (1, 2)):
            RB._apply_intra_mb(orig, recon, a, r, c, q)
        return a, recon

    a_c, r_c = rebuild()
    with monkeypatch.context() as m:
        _numpy_bodies(m)
        a_np, r_np = rebuild()
    assert np.array_equal(a_c.coeffs, a_np.coeffs)
    assert np.array_equal(a_c.y2_coded, a_np.y2_coded)
    assert a_c.coeffs[1, 1].any() and a_c.coeffs[1, 2].any()
    for p, pn in zip((r_c.y, r_c.u, r_c.v), (r_np.y, r_np.u, r_np.v)):
        assert np.array_equal(p, pn)
