"""The fast rt interframe slice on the CPU, tolerance 0: the port's
``Encoder(quality="rt", fast=True, device="cpu")`` (so K9 and K10 run their
plain versions) against the JAX package's fast path
(encoder/encode_inter_fast.py, ``ALFALFA_FAST_INTER=1``), which is
deterministic integer code, so the two are held byte for byte:

- each dense function of ops/enc_batch.py against the JAX package's,
  int16-wrap extremes included;
- K9's and K10's plain versions against the TPU kernels in interpret mode
  (each call under one ``jax.jit``: eager interpret-mode calls trace far
  slower);
- payloads, minihashes and references of whole streams, steady frames and
  the periodic loop-filter re-climb, at 80x48 and with partial edge
  macroblocks;
- the fused quantizer pair against single-quantizer encodes of forks, the
  port's Decoder, and ``xc enc --fast``.

On the card, chip_smoke.py holds the CUDA kernels against the plain
versions and the encoder's frames against FAST_ENCODE_SHA1.
"""
import contextlib
import hashlib
import json
import os
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)    # many tiny ops: threads only add contention

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from alfalfa_tpu.bitstream.header import QuantIndices as JQuantIndices  # noqa: E402
from alfalfa_tpu.encoder import Encoder as JEncoder  # noqa: E402
from alfalfa_tpu.encoder import encode_inter_fast as JEIF  # noqa: E402
from alfalfa_tpu.encoder.encode_inter_device import (_ps_rowperm,  # noqa: E402
                                                     _scalars_for)
from alfalfa_tpu.encoder.encode_intra_device import _tile_perm  # noqa: E402
from alfalfa_tpu.ops import enc_batch as JEB  # noqa: E402
from alfalfa_tpu.ops.sixtap_pallas import pack_refs32, pad_refs  # noqa: E402

from alfalfa_tpu_torch import convert  # noqa: E402
from alfalfa_tpu_torch.bitstream.header import QuantIndices  # noqa: E402
from alfalfa_tpu_torch.cli import xc  # noqa: E402
from alfalfa_tpu_torch.decoder import Decoder  # noqa: E402
from alfalfa_tpu_torch.encoder import Encoder  # noqa: E402
from alfalfa_tpu_torch.encoder import encode_inter as EI  # noqa: E402
from alfalfa_tpu_torch.encoder import encode_inter_fast as EIF  # noqa: E402
from alfalfa_tpu_torch.ops import (enc_batch, enc_decide,  # noqa: E402
                                   enc_decide_cuda, enc_inter_cuda,
                                   enc_intra_fixup, enc_intra_fixup_cuda)
from alfalfa_tpu_torch.ops.wavefront import tile  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures"
sys.path.insert(0, str(FIXTURES))
from gen_inputs import gen_clip, write_y4m  # noqa: E402
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------- (a) enc_batch

@pytest.mark.parametrize("seed", [0, 1, 2, "extremes"])
def test_enc_batch_matches_jax(seed):
    """fdct, fwht, quantize, variance, the source intra screening and the
    chroma vector against alfalfa_tpu.ops.enc_batch; "extremes" feeds
    residuals and DCs far outside the pixel range, where the int16 wraps of
    the intermediates decide the result."""
    rng = np.random.default_rng(7 if seed == "extremes" else seed)
    hi = 2047 if seed == "extremes" else 255
    diff = rng.integers(-hi, hi + 1, (6, 5, 4, 4), dtype=np.int32)
    diff[0, 0] = hi
    diff[0, 1] = -hi
    dc = rng.integers(-8 * hi, 8 * hi + 1, (7, 16), dtype=np.int32)
    dc[0] = 8 * hi
    np.testing.assert_array_equal(enc_batch.fdct_blocks(_t(diff)).numpy(),
                                  np.asarray(JEB.fdct_blocks(jnp.asarray(diff))))
    np.testing.assert_array_equal(enc_batch.fwht_blocks(_t(dc)).numpy(),
                                  np.asarray(JEB.fwht_blocks(jnp.asarray(dc))))
    co = rng.integers(-32768, 32768, (9, 16), dtype=np.int32)
    for f_dc, f_ac in ((4, 4), (7, 157), (132, 1)):
        np.testing.assert_array_equal(
            enc_batch.quantize_blocks(_t(co), f_dc, f_ac).numpy(),
            np.asarray(JEB.quantize_blocks(jnp.asarray(co), jnp.int32(f_dc),
                                           jnp.int32(f_ac))))
    d = rng.integers(-255, 256, (5, 256), dtype=np.int32)
    d[0] = 255                                # s*s overflows int32
    d[1, ::2], d[1, 1::2] = 255, -255         # the largest variance
    np.testing.assert_array_equal(enc_batch.variance_blocks(_t(d)).numpy(),
                                  np.asarray(JEB.variance_blocks(jnp.asarray(d))))
    v = rng.integers(-1100, 1100, (40,), dtype=np.int32)
    np.testing.assert_array_equal(enc_batch.chroma_mv(_t(v)).numpy(),
                                  np.asarray(JEB.chroma_mv(jnp.asarray(v))))
    R, C = 3, 4
    oy = rng.integers(0, 256, (R, C, 256)).astype(np.int16)
    if seed == "extremes":
        oy[:, :, ::2] = 255
        oy[:, :, 1::2] = 0
    mbc = np.array([663, 663, 663, 663, 0, 0, 0, 0], np.int32)
    mbc[:5] = rng.integers(0, 2000, 5)
    for rm, dm in ((716, 1), (26, 100), (3, 100)):
        got = enc_batch.intra_screen_source(
            _t(oy).reshape(R, C, 16, 16), _t(mbc[:5]), rm, dm)
        want = JEB.intra_screen_source(jnp.asarray(oy), jnp.asarray(mbc),
                                       jnp.int32(rm), jnp.int32(dm))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------- (b), (c) K9 and K10

def _decide_case(name, w, h):
    """(LAST planes, original planes) with real motion."""
    if name == "clip":
        clip = gen_clip(w, h, 3, seed=21)
        return clip[0], clip[2]
    seed, shift = name
    return chip_smoke.extreme_motion_planes(seed, w, h, shift)


def test_k9_plain_matches_pallas_interpret():
    """decide_inter_frame_plain against the TPU kernel
    (enc_decide_pallas.decide_inter_frame, realtime, interpret mode) on the
    JAX side's layouts: the phase-split source, the packed padded LAST,
    the 16-wide scalars, the source-screened intra costs; a clip with
    moving content at two quantizers and seeded motion of 23 and 3 pixels,
    at 80x80 (5 x 5 macroblocks: the search runs on four of them)."""
    from alfalfa_tpu.ops import enc_decide_pallas as EDP
    w, h = 80, 80
    R, C = h // 16, w // 16
    rp16 = _ps_rowperm(16)
    tables = EI.inter_tables(Encoder(w, h, device="cpu"))
    fn = jax.jit(lambda *a: EDP.decide_inter_frame(*a, realtime=True,
                                                   interpret=True))
    seen = set()
    for name, qi in (("clip", 20), ("clip", 72), ((5, 23), 72), ((3, 3), 20)):
        last, orig = _decide_case(name, w, h)
        oy_t = orig[0].reshape(R, 16, C, 16).transpose(0, 2, 1, 3)
        oy_t = np.ascontiguousarray(oy_t).astype(np.int16)
        refy_p = pack_refs32(pad_refs(jnp.asarray(last[0])))
        sc = _scalars_for(JQuantIndices(y_ac_qi=qi))
        icost = JEB.intra_screen_source(
            jnp.asarray(oy_t.reshape(R, C, 256)),
            jnp.asarray(np.pad(tables[0].numpy(), (0, 3))),
            jnp.int32(sc[6]), jnp.int32(sc[7]))
        want = np.asarray(fn(jnp.asarray(oy_t[:, :, rp16, :]), refy_p,
                             jnp.asarray(sc), icost,
                             *(jnp.asarray(t.numpy()) for t in tables[2:])))
        got = enc_decide.decide_inter_frame_plain(
            _t(orig[0]), _t(last[0]), _t(sc[None, :9]),
            _t(np.asarray(icost)[None]), tables[2:])[0]
        np.testing.assert_array_equal(got[..., :4].numpy(), want[..., :4],
                                      err_msg="%s qi %d" % (name, qi))
        seen.update(got[..., 1].flatten().tolist())
    # intra, ZEROMV, NEARESTMV and NEWMV were decided (NEARMV needs two
    # distinct neighbour vectors: K8's census, which K9 shares, is held
    # to the host loop in tests/test_torch_inter_encoder.py)
    assert {0, 5, 7, 8} <= seen


def test_k10_plain_matches_pallas_interpret():
    """intra_fixup_frame_plain against the TPU kernel
    (enc_intra_fixup_pallas.intra_fixup_frame, interpret mode) on a
    decision field with intra macroblocks at (0, 0), adjacent to each other
    and isolated, over seeded inter reconstruction, at two quantizers."""
    from alfalfa_tpu.ops import enc_intra_fixup_pallas as FIX
    w, h = 80, 48
    R, C = h // 16, w // 16
    rng = np.random.default_rng(3)
    clip = gen_clip(w, h, 2, seed=9)
    orig = clip[1]
    intra = np.zeros((R, C), bool)
    for r, c in ((0, 0), (0, 1), (1, 1), (1, 3), (2, 4)):
        intra[r, c] = True
    md = np.zeros((R, C, 8), np.int32)
    md[..., 0] = ~intra
    rec = [np.clip(p.astype(int) + rng.integers(-9, 10, p.shape), 0, 255)
           .astype(np.uint8) for p in clip[0]]
    perm16, perm8 = _tile_perm(16), _tile_perm(8)
    tiles = lambda p, S: tile(_t(p)[None], S)[0].reshape(R, C, S * S) \
        .numpy().astype(np.int16)
    oy_t, ou_t, ov_t = tiles(orig[0], 16), tiles(orig[1], 8), tiles(orig[2], 8)
    ry, ru, rv = tiles(rec[0], 16), tiles(rec[1], 8), tiles(rec[2], 8)
    mbc = EI.inter_tables(Encoder(w, h, device="cpu"))[0]
    fn = jax.jit(lambda *a: FIX.intra_fixup_frame(*a, interpret=True))
    qis = (4, 60)
    scalars = np.stack([_scalars_for(JQuantIndices(y_ac_qi=q)) for q in qis])
    got = enc_intra_fixup.intra_fixup_frame_plain(
        _t(orig[0]), _t(orig[1]), _t(orig[2]),
        _t(np.broadcast_to(md, (2,) + md.shape)),
        *(_t(np.broadcast_to(p, (2,) + p.shape)) for p in rec),
        _t(scalars[:, :9]), mbc)
    co, md2, y, u, v = got
    for i, qi in enumerate(qis):
        want = fn(jnp.asarray(md.astype(np.int16)), jnp.asarray(oy_t),
                  jnp.asarray(oy_t[:, :, perm16]), jnp.asarray(ou_t),
                  jnp.asarray(ov_t), jnp.asarray(ou_t[:, :, perm8]),
                  jnp.asarray(ov_t[:, :, perm8]), jnp.asarray(ry),
                  jnp.asarray(ru), jnp.asarray(rv), jnp.asarray(scalars[i]),
                  jnp.asarray(np.pad(mbc.numpy(), (0, 3))))
        w_co, w_md2, w_y, w_u, w_v = (np.asarray(x) for x in want)
        np.testing.assert_array_equal(co[i].reshape(R, C, 400).numpy(), w_co)
        np.testing.assert_array_equal(md2[i].numpy(), w_md2[..., :3])
        for pl, wt, S in ((y, w_y, 16), (u, w_u, 8), (v, w_v, 8)):
            np.testing.assert_array_equal(
                tile(pl[i][None], S)[0].reshape(R, C, S * S).numpy(), wt)
        assert (w_md2[..., 2][intra] != 0).any()
    # the two quantizers' modes or coefficients differ somewhere
    assert not torch.equal(co[0], co[1])


def test_k9_k10_wrappers_take_plain_versions_only_on_cpu():
    w, h = 48, 32
    R, C = h // 16, w // 16
    clip = gen_clip(w, h, 2, seed=4)
    enc = Encoder(w, h, device="cpu", quality="rt", fast=True)
    enc.encode_with_quantizer(clip[0], 40, key_frame=True)
    oy, ou, ov, ly, lu, lv, sc, tables = EI.kernel_inputs(
        enc, clip[1], [QuantIndices(y_ac_qi=40)])[:8]
    icost = enc_batch.intra_screen_source(tile(oy[None], 16)[0], tables[0],
                                          int(sc[0, 6]), int(sc[0, 7]))[None]
    before = (enc_decide_cuda.launches, enc_intra_fixup_cuda.launches)
    md = enc_decide_cuda.decide_inter_frame(oy, ly, sc, icost, tables[2:])
    assert torch.equal(md, enc_decide.decide_inter_frame_plain(
        oy, ly, sc, icost, tables[2:]))
    md[0, 0, 0, 0] = 0          # an intra macroblock at (0, 0)
    rec = [p[None].clone() for p in (ly, lu, lv)]
    for a, b in zip(enc_intra_fixup_cuda.intra_fixup_frame(
                        oy, ou, ov, md, *rec, sc, tables[0]),
                    enc_intra_fixup.intra_fixup_frame_plain(
                        oy, ou, ov, md, *rec, sc, tables[0])):
        assert torch.equal(a, b)
    assert (enc_decide_cuda.launches, enc_intra_fixup_cuda.launches) == before
    assert md.shape == (1, R, C, enc_decide.DECIDE_WORDS)


# ------------------------------------------------- (d) the whole path

_JITTED = {}    # the JAX side's functions under jax.jit, shared by the
                # tests of a process (80x48 and 76x44 are both 3 x 5
                # macroblocks)


def _jitted(name, R, C, make):
    """jax.jit of make(), traced on first call, kept per process."""
    if (name, R, C) not in _JITTED:
        _JITTED[name, R, C] = jax.jit(make())
    return _JITTED[name, R, C]


@contextlib.contextmanager
def jax_fast_path(R, C, *more):
    """The JAX package's fast path as the port's comparisons need it on a
    CPU host, for R x C macroblocks (and each (R, C) of ``more``: the size
    search's mosaic): ALFALFA_FAST_INTER=1, and _fast_raw, its quantizer
    pair (vmapped) and the device loop-filter passes (steady frames, the
    reference cache) each under one jax.jit: on a CPU the JAX package runs
    them eagerly in interpret mode, minutes a frame.  Its encoders encode
    the key frame on the host (device_encode=False) and take the fast path
    once device_encode is turned on."""
    from alfalfa_tpu.encoder import encode_inter_device as JEID
    shapes = [(R, C)] + [tuple(s) for s in more]
    fast = {(r, c): _jitted("fast", r, c,
                            lambda r=r, c=c: JEIF._fast_raw(r, c, True, False,
                                                            True))
            for r, c in shapes}
    caches = [entry for r, c in shapes for entry in (
        (JEIF._FN_CACHE, (r, c, True, 2, False, "multiqp"),
         _jitted("pair", r, c, lambda r=r, c=c: jax.vmap(
             JEIF._fast_raw(r, c, True, False),
             in_axes=(None,) * 6 + (0,) + (None,) * 6))),
        (JEIF._LF_CACHE, (r, c, True), _jitted(
            "lf", r, c, lambda r=r, c=c: JEIF._lf_filter_and_pack_fn(
                r, c, True))),
        (JEID._LFPACK_CACHE, (r, c, True), _jitted(
            "lfpack", r, c, lambda r=r, c=c: JEID._lf_pack_fn(r, c, True))))]
    saved = (JEIF._fast_fn, os.environ.get("ALFALFA_FAST_INTER"),
             [cache.get(key) for cache, key, _ in caches])
    JEIF._fast_fn = lambda r, c, *a: fast[r, c]
    os.environ["ALFALFA_FAST_INTER"] = "1"
    for cache, key, fn in caches:
        cache[key] = fn
    try:
        yield
    finally:
        JEIF._fast_fn = saved[0]
        if saved[1] is None:
            os.environ.pop("ALFALFA_FAST_INTER")
        else:
            os.environ["ALFALFA_FAST_INTER"] = saved[1]
        for (cache, key, _), old in zip(caches, saved[2]):
            if old is None:
                cache.pop(key, None)
            else:
                cache[key] = old


@pytest.mark.parametrize("size,qi,first", [((80, 48), 64, 0),
                                           ((76, 44), 48, 15)])
def test_fast_stream_byte_identical_to_jax(size, qi, first, monkeypatch):
    """A key frame and four fast interframes: payloads, minihashes,
    loop-filter levels and the LAST planes after each.  ``first`` presets
    both encoders' fast-frame counters: from 0 the first interframe
    re-climbs the loop filter and the rest are steady; from 15 the first is
    steady and the second re-climbs by the 16-frame period."""
    w, h = size
    with jax_fast_path((h + 15) // 16, (w + 15) // 16):
        _fast_stream(w, h, qi, first, monkeypatch)


def _fast_stream(w, h, qi, first, monkeypatch):
    jenc = JEncoder(w, h, quality="rt", device_encode=False)
    enc = Encoder(w, h, quality="rt", fast=True, device="cpu")
    jenc._fast_frame_no = enc._fast_frame_no = first
    calls, intra = [], []
    monkeypatch.setattr(EIF, "finish_interframe",
                        lambda *a: calls.append(1) or
                        EI.finish_interframe(*a))
    monkeypatch.setattr(enc_inter_cuda, "encode_inter_frame_plain",
                        lambda *a: pytest.fail("the fast path ran K8"))
    implied = EIF._implied_bmodes
    monkeypatch.setattr(EIF, "_implied_bmodes", lambda arrays: intra.append(
        int((arrays.ref == EIF.T.CURRENT_FRAME).sum())) or implied(arrays))
    for i, f in enumerate(gen_clip(w, h, 5, seed=7)):
        p = enc.encode_with_quantizer(f, qi, key_frame=i == 0)
        assert p == jenc.encode_with_quantizer(f, qi, key_frame=i == 0), \
            "frame %d differs" % i
        jenc.device_encode = True
        assert enc.minihash() == jenc.minihash()
        assert enc.last_loop_filter_level == jenc.last_loop_filter_level
        assert enc.last_ssim == jenc.last_ssim
        np.testing.assert_array_equal(enc.references.last.y.numpy(),
                                      np.asarray(jenc.references.last.y))
    assert enc._fast_frame_no == jenc._fast_frame_no == first + 4
    assert len(calls) == 1          # one re-climb frame
    assert len(intra) == 4 and sum(intra) > 0


# ------------------------------------------------ (e) the fused pair

def test_fast_pair_equals_single_encodes_and_decodes():
    """encode_interframe_fast_multiqp (one K9 and one K10 call for both
    quantizers) against each quantizer's single fast encode of a fork:
    payloads, SSIM and minihashes, three frames on; each stream decodes
    through the port's Decoder to its encoder's minihash."""
    w, h = 80, 48
    clip = gen_clip(w, h, 4, seed=23)
    qis = (40, 72)
    base = Encoder(w, h, quality="rt", fast=True, device="cpu")
    kf = base.encode_with_quantizer(clip[0], 56, key_frame=True)
    dec = Decoder(w, h, device="cpu")
    dec.decode_frame(kf)
    for f in clip[1:]:
        forks = [base.fork() for _ in qis]
        singles = [base.fork() for _ in qis]
        got = EIF.encode_interframe_fast_multiqp(
            forks, f, [QuantIndices(y_ac_qi=q) for q in qis])
        for (payload, quality), s, fk, q in zip(got, singles, forks, qis):
            assert payload == s.encode_with_quantizer(f, q)
            assert quality == s.last_ssim
            assert fk.minihash() == s.minihash()
            assert fk._fast_frame_no == s._fast_frame_no
            d = dec.copy()
            d.decode_frame(payload)
            assert d.minihash() == fk.minihash()
        assert got[0][0] != got[1][0]
        base = forks[0]                 # on with the qi 40 stream
        dec.decode_frame(got[0][0])
    with pytest.raises(ValueError, match="rt"):
        best = Encoder(w, h, device="cpu", fast=True)
        EIF.encode_interframe_fast_multiqp([best, best.fork()], clip[1],
                                           [QuantIndices(y_ac_qi=q)
                                            for q in qis])


def test_fast_flag_only_in_rt_and_carried(monkeypatch):
    """fast=True leaves a best-quality encoder on K8 (its frames equal
    fast=False's); fork, estimate_frame_size's trial encoder and
    convert.encoder_to_dict / encoder_from_dict carry the flag and the
    fast-frame counter, which a JAX encoder's dict lacks until its first
    fast frame."""
    w, h = 48, 32
    clip = gen_clip(w, h, 3, seed=5)
    a = Encoder(w, h, device="cpu", fast=True)
    b = Encoder(w, h, device="cpu")
    for i, f in enumerate(clip[:2]):
        assert a.encode_with_quantizer(f, 44) == b.encode_with_quantizer(f, 44)
    assert a._fast_frame_no == 0
    rt = Encoder(w, h, device="cpu", quality="rt", fast=True)
    rt.encode_with_quantizer(clip[0], 44)
    rt.encode_with_quantizer(clip[1], 44)
    assert rt._fast_frame_no == 1 and rt.fork()._fast_frame_no == 1
    seen = []
    encode = EIF._encode
    monkeypatch.setattr(EIF, "_encode", lambda encoders, *a: seen.append(
        encoders[0].fast) or encode(encoders, *a))
    rt.estimate_frame_size(clip[2], 40)
    assert seen == [True]
    d = convert.encoder_to_dict(rt)
    assert d["fast"] is True and d["_fast_frame_no"] == 1
    back = convert.encoder_from_dict(d, device="cpu")
    assert back.fast and back._fast_frame_no == 1
    assert back.encode_with_quantizer(clip[2], 40) == \
        rt.encode_with_quantizer(clip[2], 40)
    jd = convert.encoder_to_dict(JEncoder(w, h, quality="rt"))
    assert jd["fast"] is False and jd["_fast_frame_no"] == 0


# ----------------------------------------------------- (f) the CLI

def test_xc_enc_fast(tmp_path):
    """``xc enc --fast -q rt --device cpu`` writes the frames of
    Encoder(fast=True); under -q best it refuses with rc 2."""
    w, h = 48, 32
    clip = gen_clip(w, h, 3, seed=17)
    y4m = tmp_path / "in.y4m"
    write_y4m(str(y4m), clip, w, h)
    out = tmp_path / "out.ivf"
    assert not xc.main(["enc", str(y4m), "-o", str(out), "-y", "36", "-q",
                        "rt", "--fast", "--device", "cpu"])
    enc = Encoder(w, h, quality="rt", fast=True, device="cpu")
    from alfalfa_tpu_torch.util.ivf import IVFReader
    ivf = IVFReader(str(out))
    assert len(ivf) == 3
    for i, f in enumerate(clip):
        assert ivf.frame(i) == enc.encode_with_quantizer(f, 36)


def test_xc_enc_fast_requires_rt(tmp_path, capsys):
    y4m = tmp_path / "in.y4m"
    write_y4m(str(y4m), gen_clip(32, 32, 1), 32, 32)
    assert xc.main(["enc", str(y4m), "-o", str(tmp_path / "o.ivf"),
                    "--fast", "--device", "cpu"]) == 2
    assert "--fast requires -q rt" in capsys.readouterr().err


# ------------------------------------------------------------ slow

def jax_fast_digests():
    """chip_smoke.FAST_ENCODE_SHA1 from the JAX package: its FilePlayer
    decodes the 720p fixture (checked against the manifest), its rt encoder
    on the fast path encodes the frames as chip_smoke's fast_encode phase
    does, the pair as two forks each through encode_interframe_fast_multiqp
    (jitted; vmapped over the quantizers)."""
    from alfalfa_tpu.decoder.decoder import FilePlayer as JFilePlayer
    clip = FIXTURES / "inter_1280x720_q48.ivf"
    digest, frames = hashlib.sha1(), []
    for raster in JFilePlayer(str(clip)):
        digest.update(raster.dump_bytes())
        frames.append(tuple(np.array(p) for p in raster.display()))
    with open(FIXTURES / "manifest.json") as fh:
        assert digest.hexdigest() == json.load(fh)[clip.name]["yuv_sha1"]
    sha = lambda p: hashlib.sha1(p).hexdigest()
    got = {}
    with jax_fast_path(45, 80):
        enc = JEncoder(1280, 720, quality="rt", device_encode=False)
        for label, k in zip(chip_smoke.fast_labels("fast"),
                            (0,) + chip_smoke.FAST_ORDER):
            got[label] = sha(enc.encode_with_quantizer(
                frames[k], chip_smoke.FAST_QI, key_frame=not got))
            enc.device_encode = True
        labels = iter(chip_smoke.fast_labels("fast_pair"))
        enc = JEncoder(1280, 720, quality="rt", device_encode=False)
        got[next(labels)] = sha(enc.encode_with_quantizer(
            frames[0], chip_smoke.FAST_PAIR_KEY_QI, key_frame=True))
        enc.device_encode = True
        for k in range(1, chip_smoke.FAST_PAIR_FRAMES + 1):
            forks = [enc.fork() for _ in chip_smoke.FAST_PAIR_QIS]
            res = JEIF.encode_interframe_fast_multiqp(
                forks, frames[k], [JQuantIndices(y_ac_qi=q)
                                   for q in chip_smoke.FAST_PAIR_QIS],
                interpret=True)
            for payload, _ in res:
                got[next(labels)] = sha(payload)
            enc = forks[0]
    return got


@pytest.mark.slow
def test_chip_smoke_fast_digests_from_jax():
    """chip_smoke.FAST_ENCODE_SHA1, recomputed with the JAX package (a few
    minutes of CPU)."""
    assert jax_fast_digests() == chip_smoke.FAST_ENCODE_SHA1


@pytest.mark.slow
def test_fast_pair_matches_jax_pair():
    """The port's pair against the JAX package's vmapped pair at 80x48."""
    w, h = 80, 48
    R, C = h // 16, w // 16
    clip = gen_clip(w, h, 3, seed=23)
    qis = (40, 72)
    with jax_fast_path(R, C):
        jenc = JEncoder(w, h, quality="rt", device_encode=False)
        enc = Encoder(w, h, quality="rt", fast=True, device="cpu")
        assert enc.encode_with_quantizer(clip[0], 56) == \
            jenc.encode_with_quantizer(clip[0], 56)
        jenc.device_encode = True
        for f in clip[1:]:
            jf = [jenc.fork() for _ in qis]
            pf = [enc.fork() for _ in qis]
            want = JEIF.encode_interframe_fast_multiqp(
                jf, f, [JQuantIndices(y_ac_qi=q) for q in qis],
                interpret=True)
            got = EIF.encode_interframe_fast_multiqp(
                pf, f, [QuantIndices(y_ac_qi=q) for q in qis])
            assert [p for p, _ in got] == [p for p, _ in want]
            assert [e.minihash() for e in pf] == [e.minihash() for e in jf]
            jenc, enc = jf[0], pf[0]
