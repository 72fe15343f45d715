"""The port's dense ops against their JAX twins, on the CPU.

Same inputs, made with numpy from a fixed seed, go through the JAX function
(``alfalfa_tpu.ops``) and its counterpart in ``alfalfa_tpu_torch.ops``.
All arithmetic is integer, so the tolerance is 0 everywhere.  The JAX side
runs under ``jax.jit``: one compile costs less than its ops one by one.
The device step's small formulas (chroma motion vectors, loop-filter
limits, reference update order, coefficient scatter) are held against
numpy or the JAX package's own helpers.
"""
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)    # many tiny ops: threads only add contention
import jax
import jax.numpy as jnp

from alfalfa_tpu.ops import transforms as JT, loopfilter as JL, intra as JI, \
    sixtap as JS
from alfalfa_tpu.parallel import gop as JG
from alfalfa_tpu_torch.ops import transforms as TT, loopfilter as TL, \
    intra as TI, sixtap as TS
from alfalfa_tpu_torch.parallel import gop as TG

REPO = pathlib.Path(__file__).resolve().parent.parent


def t(a, dtype=None):
    out = torch.from_numpy(np.ascontiguousarray(a))
    return out if dtype is None else out.to(dtype)


def eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ------------------------------------------------------------- transforms

def _coeff_cases(rng, n):
    c = rng.integers(-2048, 2048, (n, 16)).astype(np.int32)
    c[0] = 2047                 # int16-wrap extremes: 2047 * 157 > 2^15
    c[1] = -2047
    c[2] = np.where(np.arange(16) % 2, 2047, -2047)
    c[3] = 0
    return c


def test_dequantize_int16_wrap_extremes():
    rng = np.random.default_rng(1)
    c = _coeff_cases(rng, 64)
    dc = np.full(64, 157, np.int32)
    ac = rng.integers(4, 158, 64).astype(np.int32)
    ac[:4] = 157
    want = JT.dequantize(jnp.asarray(c), jnp.asarray(dc), jnp.asarray(ac))
    got = TT.dequantize(t(c), t(dc), t(ac))
    eq(got, want)
    assert int(got.min()) < -30000 or int(got.max()) > 30000
    # the wrap really happened: 2047 * 157 does not fit int16
    assert int(got[0, 0]) == np.int16(np.int32(2047 * 157))


def test_iwht_matches_jax():
    rng = np.random.default_rng(2)
    y2 = rng.integers(-32768, 32768, (200, 16)).astype(np.int32)
    eq(TT.iwht(t(y2)), JT.iwht(jnp.asarray(y2)))


def test_idct_matches_jax_and_negative_shift():
    rng = np.random.default_rng(3)
    c = rng.integers(-32768, 32768, (300, 16)).astype(np.int32)
    c[0] = -1                   # negative >> must be arithmetic
    c[1] = -32768
    c[2] = 32767
    got = TT.idct(t(c))
    eq(got, JT.idct(jnp.asarray(c)))
    assert int(got.min()) < 0


def test_residuals_from_coeffs_matches_jax():
    rng = np.random.default_rng(4)
    R, C = 3, 5
    coeffs = rng.integers(-2047, 2048, (R, C, 25, 16)).astype(np.int32)
    coeffs[rng.random((R, C, 25, 16)) < 0.6] = 0
    coeffs[0, 0] = 2047
    coeffs[0, 1] = -2047
    qf = {k: rng.integers(4, 158, (R, C)).astype(np.int32)
          for k in ("y_dc", "y_ac", "y2_dc", "y2_ac", "uv_dc", "uv_ac")}
    for k in qf:
        qf[k][0, :2] = 157
    y2c = rng.random((R, C)) < 0.5
    want = jax.jit(JT.residuals_from_coeffs)(
        jnp.asarray(coeffs), {k: jnp.asarray(v) for k, v in qf.items()},
        jnp.asarray(y2c))
    # the port's version carries a leading batch axis
    got = TT.residuals_from_coeffs(
        t(coeffs)[None], {k: t(v)[None] for k, v in qf.items()}, t(y2c)[None])
    eq(got[0], want)


# ------------------------------------------------------------ loop filter

@pytest.mark.parametrize("size", [16, 8])
def test_filter_mb_window_matches_jax(size):
    rng = np.random.default_rng(10 + size)
    N = 96
    # smooth windows with a few steps so every branch (mask, hev, both
    # filters) fires somewhere
    base = rng.integers(0, 256, (N, 1, 1))
    win = np.clip(base + rng.integers(-12, 13, (N, size + 4, size + 4)),
                  0, 255).astype(np.int32)
    win[::7, :, 4:] = np.clip(win[::7, :, 4:] + 40, 0, 255)
    win[::5, 4:, :] = np.clip(win[::5, 4:, :] - 30, 0, 255)
    fl = rng.integers(1, 64, N).astype(np.int32)
    interior = np.maximum(fl >> 1, 1).astype(np.int32)
    mb_lim = ((fl + 2) * 2 + interior).astype(np.int32)
    sb_lim = (fl * 2 + interior).astype(np.int32)
    hev = rng.integers(0, 4, N).astype(np.int32)
    do_left, do_top, do_sb = (rng.random((3, N)) < 0.7)

    want = jax.jit(jax.vmap(lambda w, *p: JL.filter_mb_window(w, size, *p)))(
        jnp.asarray(win), jnp.asarray(interior)[:, None],
        jnp.asarray(mb_lim)[:, None], jnp.asarray(sb_lim)[:, None],
        jnp.asarray(hev)[:, None], jnp.asarray(do_left)[:, None, None],
        jnp.asarray(do_top)[:, None, None], jnp.asarray(do_sb)[:, None, None])
    got = TL.filter_mb_window(
        t(win), size, t(interior)[:, None], t(mb_lim)[:, None],
        t(sb_lim)[:, None], t(hev)[:, None], t(do_left)[:, None, None],
        t(do_top)[:, None, None], t(do_sb)[:, None, None])
    eq(got, want)
    assert not np.array_equal(np.asarray(got), win)


# ------------------------------------------------------------------ intra

@pytest.mark.parametrize("size", [16, 8])
def test_whole_block_predict_matches_jax(size):
    rng = np.random.default_rng(20 + size)
    N = 64
    e = rng.integers(0, 256, (N, size + 5)).astype(np.int32)
    lcol = rng.integers(0, 256, (N, size)).astype(np.int32)
    hrow, hcol = rng.random((2, N)) < 0.7
    mode = rng.integers(0, 4, N).astype(np.int32)
    want = jax.jit(jax.vmap(lambda a, b, c, d, m: JI.whole_block_predict(
        a, b, c, d, m, size)))(jnp.asarray(e), jnp.asarray(lcol),
                              jnp.asarray(hrow), jnp.asarray(hcol),
                              jnp.asarray(mode))
    eq(TI.whole_block_predict(t(e), t(lcol), t(hrow), t(hcol), t(mode), size),
       want)


def test_subblock_predict_all_matches_jax():
    rng = np.random.default_rng(30)
    N = 128
    above, left, ar = (rng.integers(0, 256, (3, N, 4)).astype(np.int32))
    al = rng.integers(0, 256, N).astype(np.int32)
    want = jax.jit(jax.vmap(JI.subblock_predict_all))(
        jnp.asarray(above), jnp.asarray(left), jnp.asarray(al),
        jnp.asarray(ar))
    eq(TI.subblock_predict_all(t(above), t(left), t(al), t(ar)), want)


def test_bpred_tile_matches_jax():
    rng = np.random.default_rng(31)
    N = 24
    e21 = rng.integers(0, 256, (N, 21)).astype(np.int32)
    lcol = rng.integers(0, 256, (N, 16)).astype(np.int32)
    bm = rng.integers(0, 10, (N, 4, 4)).astype(np.int32)
    res = rng.integers(-255, 256, (N, 16, 4, 4)).astype(np.int32)
    nz = rng.random(N) < 0.7
    want = jax.jit(jax.vmap(JI.bpred_tile))(jnp.asarray(e21), jnp.asarray(lcol),
                                   jnp.asarray(bm), jnp.asarray(res),
                                   jnp.asarray(nz))
    eq(TI.bpred_tile(t(e21), t(lcol), t(bm), t(res), t(nz)), want)


# ----------------------------------------------------------------- sixtap

@pytest.mark.parametrize("S", [16, 8])
def test_predict_mb_tiles_matches_jax(S):
    rng = np.random.default_rng(40 + S)
    R, C, n = 4, 6, S // 4
    refs = rng.integers(0, 256, (4, R * S, C * S)).astype(np.uint8)
    sel = rng.integers(0, 4, (R, C)).astype(np.int32)
    mv = np.broadcast_to(rng.integers(-60, 60, (R, C, 1, 1, 2)),
                         (R, C, n, n, 2)).astype(np.int32).copy()
    mv[0, 0] = rng.integers(-40, 40, (n, n, 2))     # SPLITMV
    mv[1, 1] = [900, -900]                          # fully outside
    mv[2, 2] = [-2000, 2000]
    mv[3, 3] = [40, -16]                            # full-pel
    mv[3, 4] = [8, 3]                               # x full-pel, y sub-pel
    want = jax.jit(JS.predict_mb_tiles, static_argnums=3)(
        jnp.asarray(refs), jnp.asarray(sel), jnp.asarray(mv), S)
    eq(TS.predict_mb_tiles(t(refs), t(sel), t(mv), S), want)


# ------------------------------------------- the device step's formulas

def test_chroma_mvs_symmetric_rounding():
    rng = np.random.default_rng(50)
    smv = rng.integers(-300, 300, (2, 3, 4, 4, 4, 2)).astype(np.int32)
    smv[0, 0, 0] = -1       # q = -4 -> -(8 >> 3) = -1, not floor
    smv[0, 0, 1] = 1
    smv[0, 0, 2, :2, :2] = [[[-1, 0], [0, 0]], [[0, 0], [0, 1]]]
    q = smv.reshape(2, 3, 4, 2, 2, 2, 2, 2).sum(axis=(4, 6))
    want = np.sign(q) * ((np.abs(q) + 4) >> 3)
    got = TG.chroma_mvs(t(smv))
    eq(got, want)
    assert got.dtype == torch.int32
    assert int(got[0, 0, 0, 0, 0, 0]) == -1 and int(got[0, 0, 1, 0, 0, 0]) == 1


@pytest.mark.parametrize("key_frame", [True, False])
def test_loop_filter_limits(key_frame):
    rng = np.random.default_rng(51)
    G, R, C = 4, 3, 5
    base = rng.integers(-10, 80, (G, R, C)).astype(np.int32)
    base[0, 0, :5] = [0, 14, 15, 20, 40]
    sharp = np.array([0, 3, 5, 7], np.int32)
    y2c, nz = rng.random((2, G, R, C)) < 0.5
    # the reference's expressions (parallel/gop.py, the device step)
    s = sharp[:, None, None]
    fl = np.clip(base, 0, 63)
    interior = np.where(s > 0, np.minimum(fl >> np.where(s > 4, 2, 1), 9 - s),
                        fl)
    interior = np.maximum(interior, 1)
    hev = ((fl >= 15).astype(np.int32) + (fl >= 40)
           + ((fl >= 20) & (not key_frame)))
    want = (np.where(base > 0, fl, 0), interior, (fl + 2) * 2 + interior,
            fl * 2 + interior, hev, y2c & ~nz)
    got = TG.loop_filter_limits(t(base), t(sharp), t(y2c), t(nz), key_frame)
    for g, w in zip(got, want):
        eq(g, w)
    assert int(got[1].min()) >= 1
    assert int(got[4][0, 0, 3]) == (1 if key_frame else 2)  # fl = 20


def test_update_references_order():
    """alt is updated first; golden <- alternate reads the UPDATED alt;
    then the refresh selects; key frames set all three."""
    G, H, W = 6, 4, 4
    last = np.full((G, H, W), 10, np.uint8)
    gold = np.full((G, H, W), 20, np.uint8)
    alt = np.full((G, H, W), 30, np.uint8)
    new = np.full((G, H, W), 99, np.uint8)
    refs = t(np.stack([last, gold, alt], axis=1))
    #        copy_alt copy_gold r_gold r_alt r_last      -> last gold alt
    cases = [(0, 0, 0, 0, 1),                            # 99 20 30
             (1, 2, 0, 0, 1),    # alt<-last, gold<-NEW alt   99 10 10
             (2, 1, 0, 0, 0),    # alt<-gold, gold<-last      10 10 20
             (0, 2, 0, 1, 1),    # gold<-alt(30), alt<-frame  99 30 99
             (2, 0, 1, 0, 0),    # alt<-gold, gold<-frame     10 99 20
             (1, 1, 1, 1, 1)]    # refresh wins over copies   99 99 99
    want = [(99, 20, 30), (99, 10, 10), (10, 10, 20), (99, 30, 99),
            (10, 99, 20), (99, 99, 99)]
    fls = t(np.array(cases, np.int32).T.copy())
    out = TG.update_references(refs, t(new), fls, key_frame=False)
    assert out.shape == (G, 3, H, W)
    for g in range(G):
        assert tuple(int(out[g, k, 0, 0]) for k in range(3)) == want[g], g
    kf = TG.update_references(refs, t(new), fls, key_frame=True)
    assert bool((kf == 99).all())


def _compact_stream(rng, ne, n_nz, cap, ecap):
    """A compact coefficient stream with delta and value escapes and the
    padding parse_frame_batch appends (positions == cap are out of range)."""
    idx = np.sort(rng.choice(ne, n_nz, replace=False))
    val = rng.integers(-2047, 2048, n_nz)
    val[val == 0] = 1
    d = np.diff(idx, prepend=-1)
    dpos = np.flatnonzero(d > 255)
    vpos = np.flatnonzero((val < -128) | (val > 127))
    assert len(dpos) and len(vpos) and max(len(dpos), len(vpos)) < ecap
    coeff_delta = np.ones(cap, np.uint8)
    coeff_val8 = np.zeros(cap, np.int8)
    coeff_delta[:n_nz] = np.minimum(d, 255)
    coeff_val8[:n_nz] = np.where((val < -128) | (val > 127), 0, val)
    desc_pos = np.full(ecap, cap, np.int32)
    desc_extra = np.zeros(ecap, np.int32)
    vesc_pos = np.full(ecap, cap, np.int32)
    vesc_val = np.zeros(ecap, np.int16)
    desc_pos[:len(dpos)] = dpos
    desc_extra[:len(dpos)] = d[dpos] - 255
    vesc_pos[:len(vpos)] = vpos
    vesc_val[:len(vpos)] = val[vpos]
    dense = np.zeros(ne, np.int16)
    dense[idx] = val
    return (coeff_delta, coeff_val8, desc_pos, desc_extra, vesc_pos,
            vesc_val), dense


def test_scatter_coeffs_out_of_range_pads():
    rng = np.random.default_rng(52)
    G, R, C = 2, 2, 3
    ne = G * R * C * 400
    stream, dense = _compact_stream(rng, ne, 40, 256, 64)
    got = TG._scatter_coeffs(G, R, C, *(t(a) for a in stream))
    assert got.dtype == torch.int16 and got.shape == (G, R, C, 25, 16)
    eq(got.reshape(-1), dense)
    want = JG._scatter_coeffs(G, R, C, *(jnp.asarray(a) for a in stream))
    eq(got, want)


def test_pack_unpack_upload_roundtrip():
    rng = np.random.default_rng(53)
    batch = {"buf8": rng.integers(-5, 5, (2, 3, 5, 6)).astype(np.int8),
             "buf16": rng.integers(-999, 999, 77).astype(np.int16),
             "split_idx": rng.integers(0, 30, 9).astype(np.int32),
             "coeff_delta": rng.integers(0, 255, 33).astype(np.uint8),
             "coeff_val8": rng.integers(-128, 127, 33).astype(np.int8),
             "desc_pos": np.arange(5, dtype=np.int32),
             "desc_extra": np.arange(5, dtype=np.int32),
             "vesc_pos": np.arange(5, dtype=np.int32),
             "vesc_val": np.arange(5, dtype=np.int16), "absent": None}
    keep = {k: v.copy() for k, v in batch.items() if v is not None}
    mega, spec_r, spec_c, off = TG._pack_merged(batch)
    assert mega.dtype == np.uint8 and off % 16 == 0
    out = TG._unpack_upload(torch.from_numpy(mega), spec_r + spec_c)
    assert set(out) == set(keep)
    for k, v in keep.items():
        eq(out[k], v)
        assert tuple(out[k].shape) == v.shape


# -------------------------------------------------------- no JAX imports

def test_port_imports_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|alfalfa_tpu)\b", re.M)
    files = sorted((REPO / "alfalfa_tpu_torch").rglob("*.py")) \
        + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    names = {str(f.relative_to(REPO)) for f in files}
    assert {"alfalfa_tpu_torch/cli/xc.py", "alfalfa_tpu_torch/decoder/decoder.py",
            "alfalfa_tpu_torch/state/serdes.py", "alfalfa_tpu_torch/util/y4m.py",
            "alfalfa_tpu_torch/ops/intra_cuda.py",
            "alfalfa_tpu_torch/ops/lf_cuda.py",
            "alfalfa_tpu_torch/ops/enc_intra_cuda.py",
            "alfalfa_tpu_torch/encoder/encoder.py",
            "alfalfa_tpu_torch/util/ssim.py"} <= names
    bad = [str(f.relative_to(REPO)) for f in files
           if pat.search(f.read_text())]
    assert bad == []


def test_cuda_wrapper_takes_plain_version_only_on_cpu():
    """On a CPU tensor the wrapper computes the plain version and counts no
    launch; nothing in the package asks whether CUDA is available."""
    from alfalfa_tpu_torch.ops import sixtap_cuda
    rng = np.random.default_rng(54)
    refs = t(rng.integers(0, 256, (1, 3, 32, 32)).astype(np.uint8))
    sel = t(rng.integers(0, 4, (1, 2, 2)).astype(np.int32))
    mv = t(rng.integers(-20, 20, (1, 2, 2, 4, 4, 2)).astype(np.int32))
    before = sixtap_cuda.launches
    eq(sixtap_cuda.mc_tiles(refs, sel, mv, 16),
       TS.mc_tiles_plain(refs, sel, mv, 16))
    assert sixtap_cuda.launches == before
    src = "".join(f.read_text() for f in
                  (REPO / "alfalfa_tpu_torch").rglob("*.py"))
    assert "is_available" not in src
