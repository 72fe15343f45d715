"""The keyframe-encoder slice on the CPU, tolerance 0: the port's
``Encoder(device="cpu")`` (so K7 runs its plain version) against the JAX
package's host encoder ``Encoder(device_encode=False)``, and the pieces
under it against their JAX twins:

- H1: the plain fdct / fwht / quantize against the jnp helpers of
  ops/enc_transforms_pallas.py (plain functions, not kernels);
- H2: the plain trellis against encoder/trellis.py:trellis_quantize;
- K7: encode_kf_frame_plain against the host macroblock loop
  encode_intra_np.encode_intra_mb run over every macroblock (the kernel's
  reference, which the JAX package holds its TPU kernel to);
- the serializer half of native/bitwork.py, entry by entry, and the
  parse-serialize roundtrip through the port's own parser and serializer;
- payloads, minihashes, decodes and encoders carried between the packages.

No interpret-mode call of the TPU keyframe kernel (tens of seconds a call
on the CPU).  On the card, chip_smoke.py holds the CUDA kernel against the
plain version and the encoder's frames against KF_ENCODE_SHA1.
"""
import hashlib
import json
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)    # many tiny ops: threads only add contention

import jax.numpy as jnp

from alfalfa_tpu.bitstream import tables as JT
from alfalfa_tpu.bitstream.boolcoder import BoolEncoder as JBoolEncoder
from alfalfa_tpu.bitstream.header import QuantIndices, UncompressedChunk \
    as JChunk
from alfalfa_tpu.decoder.parse import FrameArrays as JFrameArrays, \
    FrameParser as JFrameParser
from alfalfa_tpu.encoder import Encoder as JEncoder
from alfalfa_tpu.encoder import encode_intra_np, transforms_np
from alfalfa_tpu.encoder.costs import rd_multipliers
from alfalfa_tpu.encoder.encoder import _pad_raster as j_pad_raster
from alfalfa_tpu.encoder.trellis import TrellisContext, trellis_quantize \
    as j_trellis_quantize, fill_token_costs as j_fill_token_costs
from alfalfa_tpu.native import bitwork as jbitwork
from alfalfa_tpu.ops import enc_transforms_pallas as JET
from alfalfa_tpu.state import decoder_state as JDS
from alfalfa_tpu.state.decoder_state import DecoderState as JDecoderState, \
    Raster as JRaster
from alfalfa_tpu.util.ivf import IVFReader

from alfalfa_tpu_torch import convert
from alfalfa_tpu_torch.bitstream.boolcoder import BoolEncoder
from alfalfa_tpu_torch.bitstream.header import UncompressedChunk
from alfalfa_tpu_torch.decoder import Decoder
from alfalfa_tpu_torch.decoder.parse import FrameParser
from alfalfa_tpu_torch.encoder import Encoder
from alfalfa_tpu_torch.encoder.serializer import serialize_frame
from alfalfa_tpu_torch.encoder.trellis import token_costs_pm, \
    fill_token_costs
from alfalfa_tpu_torch.native import bitwork
from alfalfa_tpu_torch.ops import enc_intra_cuda, enc_transforms as ET
from alfalfa_tpu_torch.ops import trellis as TR
from alfalfa_tpu_torch.ops.enc_intra import encode_kf_frame_plain
from alfalfa_tpu_torch.state.decoder_state import DecoderState
from alfalfa_tpu_torch.util.ssim import serial_mean, ssim

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures"
sys.path.insert(0, str(FIXTURES))
from gen_inputs import gen_clip  # noqa: E402

QUANT_KEYS = ("y_dc", "y_ac", "y2_dc", "y2_ac", "uv_dc", "uv_ac")


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _quant(qi):
    q = {k: int(v) for k, v in QuantIndices(y_ac_qi=qi).quantizer().items()}
    return q, rd_multipliers(q["y_ac"])


# ------------------------------------------------------------------- H1

def test_fdct_matches_jax_and_host():
    """Residuals over the whole range a prediction can leave, in blocks of
    16 lanes as the jnp helper takes them."""
    rng = np.random.default_rng(1)
    orig = rng.integers(0, 256, (64, 16))
    pred = rng.integers(0, 256, (64, 16))
    orig[:8], pred[:8] = 255, 0              # residual +255 everywhere
    orig[8:16], pred[8:16] = 0, 255          # -255
    orig[16:24, ::2], pred[16:24, 1::2] = 0, 0
    got = ET.fdct(t(orig), t(pred)).numpy()
    want = np.asarray(JET.fdct(jnp.asarray((orig - pred).reshape(4, 256),
                                           jnp.int32))).reshape(64, 16)
    np.testing.assert_array_equal(got, want)
    for i in range(0, 64, 7):
        np.testing.assert_array_equal(got[i], transforms_np.subtract_fdct(
            orig[i].reshape(4, 4).astype(np.uint8),
            pred[i].reshape(4, 4).astype(np.uint8)))


def test_fwht_matches_jax_on_int16_extremes():
    rng = np.random.default_rng(2)
    dc = rng.integers(-2048, 2048, (48, 16))
    dc[:4] = 32767
    dc[4:8] = -32768
    dc[8:12, ::3] = -32768
    got = ET.fwht(t(dc)).numpy()
    want = np.asarray(JET.fwht(jnp.asarray(dc.reshape(3, 256), jnp.int32)))
    np.testing.assert_array_equal(got, want.reshape(48, 16))
    np.testing.assert_array_equal(got[20], transforms_np.fwht(dc[20]))


def test_quantize_matches_jax_on_int16_extremes():
    rng = np.random.default_rng(3)
    c = rng.integers(-32768, 32768, (32, 16))
    c[:2] = 32767
    c[2:4] = -32768
    c[4:6] = 0
    for dcf, acf in ((4, 4), (7, 157), (132, 1), (157, 284)):
        got = ET.quantize(t(c), dcf, acf).numpy()
        want = np.asarray(JET.quantize(jnp.asarray(c.reshape(2, 256),
                                                   jnp.int32), dcf, acf))
        np.testing.assert_array_equal(got, want.reshape(32, 16))


# ------------------------------------------------------------------- H2

def _coeff_blocks(rng, n):
    """DCT-like unquantized blocks: decaying magnitudes, zeros, runs of
    trailing zeros, and the extremes the forward transforms can reach."""
    decay = np.exp(-np.arange(16) / 4.0)
    c = (rng.normal(0, 1, (n, 16)) * rng.uniform(5, 600, (n, 1))
         * decay).astype(np.int64)
    c[rng.random((n, 16)) < 0.3] = 0
    c[n // 4:n // 2, 6:] = 0
    c[:2, 0] = 2040
    c[2:4, 0] = -2040
    c[4] = 0
    return c


@pytest.mark.parametrize("bt", [JT.BLOCK_Y_AFTER_Y2, JT.BLOCK_Y2,
                                JT.BLOCK_UV, JT.BLOCK_Y_WITHOUT_Y2])
def test_trellis_matches_host(bt):
    """Every entry context and first index, default and perturbed
    probabilities, two quantizers."""
    rng = np.random.default_rng(10 + bt)
    probs = JT.DEFAULT_COEFF_PROBS.copy()
    pert = np.clip(probs.astype(int) + rng.integers(-60, 60, probs.shape),
                   1, 255).astype(np.uint8)
    for coeff_probs in (probs, pert):
        tc_host = j_fill_token_costs(coeff_probs)
        np.testing.assert_array_equal(fill_token_costs(coeff_probs), tc_host)
        tc = t(token_costs_pm(coeff_probs)[bt])
        for qi in (10, 90):
            q, (rm, dm) = _quant(qi)
            dcf, acf = ((q["y2_dc"], q["y2_ac"]) if bt == JT.BLOCK_Y2 else
                        (q["uv_dc"], q["uv_ac"]) if bt == JT.BLOCK_UV else
                        (q["y_dc"], q["y_ac"]))
            unq = _coeff_blocks(rng, 24)
            for first in (0, 1):
                for ctx in range(3):
                    got, nz = TR.trellis_quantize(
                        t(unq), dcf, acf, tc, torch.full((24,), ctx), first,
                        rm, dm)
                    for i in range(24):
                        want = j_trellis_quantize(unq[i], dcf, acf,
                                                  tc_host[bt], ctx, first,
                                                  rm, dm)
                        np.testing.assert_array_equal(got[i].numpy(), want)
                        assert bool(nz[i]) == bool(want[first:].any())


# ------------------------------------------------------------------- K7

@pytest.mark.parametrize("w,h,qi,trellis", [(80, 48, 24, False),
                                            (80, 48, 64, True),
                                            (176, 144, 64, False),
                                            (176, 144, 24, True)])
def test_encode_kf_frame_plain_matches_host_loop(w, h, qi, trellis):
    """Coefficients, modes, y2_coded, has_nonzero and the unfiltered
    reconstruction of every macroblock (176x144: 9 x 11 macroblocks)."""
    frame = gen_clip(w, h, 1, seed=w + qi)[0]
    orig = j_pad_raster(*frame, w, h)
    R, C = (h + 15) // 16, (w + 15) // 16
    q, (rm, dm) = _quant(qi)
    arrays, recon = JFrameArrays(R, C), JRaster(w, h)
    ctx = (TrellisContext(JT.DEFAULT_COEFF_PROBS, R, C, q, rm, dm)
           if trellis else None)
    for r in range(R):
        for c in range(C):
            encode_intra_np.encode_intra_mb((orig.y, orig.u, orig.v), recon,
                                            arrays, r, c, q, rm, dm,
                                            trellis=ctx)
    tc = t(token_costs_pm(JT.DEFAULT_COEFF_PROBS)) if trellis else None
    co, md, y, u, v = encode_kf_frame_plain(
        t(orig.y), t(orig.u), t(orig.v), [q[k] for k in QUANT_KEYS], rm, dm,
        tc)
    md = md.numpy()
    np.testing.assert_array_equal(co.numpy(), arrays.coeffs)
    np.testing.assert_array_equal(md[..., 0], arrays.ymode)
    np.testing.assert_array_equal(md[..., 1], arrays.uvmode)
    np.testing.assert_array_equal(md[..., 2] != 0, arrays.y2_coded)
    np.testing.assert_array_equal(md[..., 3] != 0, arrays.has_nonzero)
    np.testing.assert_array_equal(md[..., 4:].reshape(R, C, 4, 4),
                                  arrays.bmode)
    for a, b in zip((y, u, v), (recon.y, recon.u, recon.v)):
        np.testing.assert_array_equal(a.numpy(), b)
    assert 0 < (md[..., 0] == 4).sum() < R * C     # both luma paths ran


def test_kernel_wrapper_takes_plain_version_only_on_cpu():
    frame = gen_clip(32, 32, 1, seed=4)[0]
    q, (rm, dm) = _quant(40)
    args = (t(frame[0]), t(frame[1]), t(frame[2]),
            [q[k] for k in QUANT_KEYS], rm, dm)
    before = enc_intra_cuda.launches
    for a, b in zip(enc_intra_cuda.encode_kf_frame(*args),
                    encode_kf_frame_plain(*args)):
        assert torch.equal(a, b)
    assert enc_intra_cuda.launches == before


# ------------------------------------------------- the Encoder, end to end

def _encode_both(w, h, frames, qi, **kw):
    """The same key frames through both encoders; payloads and minihashes
    equal after each.  Returns (JAX encoder, port encoder, payloads)."""
    jenc = JEncoder(w, h, device_encode=False, **kw)
    enc = Encoder(w, h, device="cpu", **kw)
    payloads = []
    for i, f in enumerate(frames):
        p = enc.encode_with_quantizer(f, qi, key_frame=True)
        assert p == jenc.encode_with_quantizer(f, qi, key_frame=True), \
            "frame %d differs" % i
        assert enc.minihash() == jenc.minihash()
        payloads.append(p)
    assert enc.last_loop_filter_level == jenc.last_loop_filter_level
    return jenc, enc, payloads


@pytest.mark.parametrize("qi", [24, 64])
def test_keyframes_byte_identical(qi):
    _encode_both(80, 48, gen_clip(80, 48, 2, seed=21), qi)


@pytest.mark.parametrize("qi", [16, 56])
def test_two_pass_keyframes_byte_identical(qi):
    _encode_both(80, 48, gen_clip(80, 48, 2, seed=31), qi, two_pass=True)


def test_two_pass_persisted_probabilities():
    """The trellis prices tokens under the persisted tables, which the
    first key frame moves away from the defaults."""
    jenc, enc, _ = _encode_both(64, 48, gen_clip(64, 48, 3, seed=33), 40,
                                two_pass=True)
    assert not np.array_equal(enc.state.probability_tables.coeff_probs,
                              JT.DEFAULT_COEFF_PROBS)


def test_odd_size_and_realtime_quality():
    """72x40 (padded macroblocks, zero fill) and quality "rt", whose
    loop-filter search is a window around the last level."""
    _encode_both(72, 40, gen_clip(72, 40, 2, seed=5), 40)
    _, enc, _ = _encode_both(80, 48, gen_clip(80, 48, 3, seed=6), 30,
                             quality="rt")
    assert enc.last_loop_filter_level > 0


def test_minimum_ssim_keyframe():
    frame = gen_clip(80, 48, 1, seed=7)[0]
    jenc = JEncoder(80, 48, device_encode=False)
    enc = Encoder(80, 48, device="cpu")
    assert enc.encode_with_minimum_ssim(frame, 0.9, key_frame=True) == \
        jenc.encode_with_minimum_ssim(frame, 0.9, key_frame=True)
    assert enc.last_y_ac_qi == jenc.last_y_ac_qi
    assert enc.minihash() == jenc.minihash()
    assert enc.last_ssim >= 0.9


def test_target_size_keyframe():
    """The size search: subsampled trial encodes (new encoders of the
    mosaic's size on the same device) steer a binary search."""
    frame = gen_clip(176, 144, 1, seed=8)[0]
    jenc = JEncoder(176, 144, device_encode=False)
    enc = Encoder(176, 144, device="cpu")
    assert enc.estimate_frame_size(frame, 40, key_frame=True) == \
        jenc.estimate_frame_size(frame, 40, key_frame=True)
    p = enc.encode_with_target_size(frame, 3000, key_frame=True)
    assert p == jenc.encode_with_target_size(frame, 3000, key_frame=True)
    assert enc.last_y_ac_qi == jenc.last_y_ac_qi
    assert enc.minihash() == jenc.minihash()


# ------------------------------------------------- decode, carry, defaults

def test_decoder_and_carry_both_ways():
    """The port's Decoder decodes each frame to the encoder's references;
    a whole encoder carried JAX -> port -> JAX (convert.encoder_to_dict /
    encoder_from_dict) goes on making the same frames; fork() is a
    value."""
    w, h = 64, 48
    clip = gen_clip(w, h, 4, seed=41)
    jenc, enc, payloads = _encode_both(w, h, clip[:2], 36, two_pass=True)
    dec = Decoder(w, h, device="cpu")
    for p in payloads:
        dec.decode_frame(p)
    assert dec.references == enc.references
    assert dec.minihash() == enc.minihash()

    port = convert.encoder_from_dict(convert.encoder_to_dict(jenc),
                                     device="cpu")
    assert port.minihash() == jenc.minihash() and port.two_pass
    back = convert.encoder_from_dict(convert.encoder_to_dict(enc),
                                     encoder_cls=JEncoder, classes=JDS)
    assert isinstance(back, JEncoder) and back.minihash() == enc.minihash()
    fork = port.fork()
    p2 = port.encode_with_quantizer(clip[2], 36, key_frame=True)
    assert p2 == back.encode_with_quantizer(clip[2], 36, key_frame=True)
    assert p2 == jenc.encode_with_quantizer(clip[2], 36, key_frame=True)
    assert port.minihash() == back.minihash() == jenc.minihash()
    assert fork.minihash() == enc.minihash() != port.minihash()
    assert (port.frame_no, port.last_y_ac_qi, port.last_loop_filter_level,
            port.last_ssim) == (jenc.frame_no, jenc.last_y_ac_qi,
                                jenc.last_loop_filter_level, jenc.last_ssim)


def test_interframes_raise_and_cuda_is_the_default():
    """Interframes raised NotImplementedError until the interframe encoder
    was ported; now they encode, byte-identical to the JAX package's (the
    slice's own tests are tests/test_torch_inter_encoder.py).  What still
    raises is the default device, CUDA, on a host without one."""
    frame = gen_clip(32, 32, 1, seed=9)[0]
    enc = Encoder(32, 32, device="cpu")
    jenc = JEncoder(32, 32, device_encode=False)
    for e in (enc, jenc):
        e.encode_with_quantizer(frame, 40)               # frame 0: key
    assert enc.encode_with_quantizer(frame, 40) == \
        jenc.encode_with_quantizer(frame, 40)            # an interframe
    assert enc.encode_with_quantizer(frame, 40, key_frame=False) == \
        jenc.encode_with_quantizer(frame, 40, key_frame=False)
    assert enc.minihash() == jenc.minihash()
    with pytest.raises((AssertionError, RuntimeError)):
        Encoder(32, 32)


# ------------------------------------------------------ serializer half

def _parsed(clip, n):
    """(key_frame, header, arrays, frame_probs) of the first n frames of a
    fixture, parsed by the JAX package."""
    ivf = IVFReader(str(FIXTURES / clip))
    state = JDecoderState.initial(ivf.width, ivf.height)
    out = []
    for i in range(n):
        chunk = JChunk(ivf.frame(i), ivf.width, ivf.height)
        header, arrays, probs = JFrameParser(state).parse(chunk)
        out.append((chunk.key_frame, header, arrays, probs))
    return out


def _written(be):
    return bytes(be.output), be.range, be.bottom, be.bit_count


def test_bitwork_serializer_entries_match_jax():
    """serialize_tokens, write_kf_modes, write_inter_modes,
    write_flagged_literals and count_token_branches of both packages on
    the same parsed arrays: the same bytes, encoder states and counts."""
    from alfalfa_tpu.decoder.parse import flipped_map_for
    frames = _parsed("inter_176x144_q96.ivf", 3)
    for key_frame, header, arrays, probs in frames:
        assert bitwork.serialize_tokens(arrays, probs.coeff_probs, 2) == \
            jbitwork.serialize_tokens(arrays, probs.coeff_probs, 2)
        np.testing.assert_array_equal(bitwork.count_token_branches(arrays),
                                      jbitwork.count_token_branches(arrays))
        be, jbe = BoolEncoder(), JBoolEncoder()
        if key_frame:
            bitwork.write_kf_modes(be, arrays, header.prob_skip_false)
            assert jbitwork.write_kf_modes(jbe, arrays,
                                           header.prob_skip_false)
        else:
            flipped = np.asarray(flipped_map_for(arrays, header))
            bitwork.write_inter_modes(be, arrays, header, probs, flipped)
            assert jbitwork.write_inter_modes(jbe, arrays, header, probs,
                                              flipped)
        assert _written(be) == _written(jbe)
    rng = np.random.default_rng(5)
    up = rng.integers(1, 256, 300).astype(np.uint8)
    flags = (rng.random(300) < 0.2).astype(np.uint8)
    vals = rng.integers(0, 256, 300).astype(np.uint8)
    be, jbe = BoolEncoder(), JBoolEncoder()
    bitwork.write_flagged_literals(be, up, flags, vals, 8)
    assert jbitwork.write_flagged_literals(jbe, up, flags, vals, 8)
    assert _written(be) == _written(jbe)


@pytest.mark.parametrize("clip", ["kf_176x144_q16.ivf",
                                  "inter_176x144_q96.ivf",
                                  "inter_176x144_rt_q48.ivf"])
def test_parse_serialize_identity(clip):
    """The port's parser then its serializer reproduce every frame (token
    and mode probability updates go through write_flagged_literals)."""
    ivf = IVFReader(str(FIXTURES / clip))
    state = DecoderState.initial(ivf.width, ivf.height)
    for i in range(len(ivf)):
        payload = ivf.frame(i)
        chunk = UncompressedChunk(payload, ivf.width, ivf.height)
        header, arrays, probs = FrameParser(state).parse(chunk)
        out = serialize_frame(header, arrays, probs, chunk.key_frame,
                              ivf.width, ivf.height, chunk.show_frame)
        assert out == payload, "frame %d of %s" % (i, clip)


def test_parse_serialize_identity_segmented_keyframe():
    """A key frame with a coded segment map (which the native key-frame
    writer does not take): the JAX package writes it, the port's parser and
    serializer reproduce it."""
    from alfalfa_tpu.bitstream.header import UpdateSegmentation
    from alfalfa_tpu.encoder.serializer import serialize_frame as jserialize
    key_frame, header, arrays, probs = _parsed("kf_176x144_q16.ivf", 1)[0]
    header.update_segmentation = UpdateSegmentation(
        update_mb_segmentation_map=True, mb_segmentation_map=[200, 160, 140])
    rows, cols = np.indices(arrays.skip_coeff.shape)
    arrays.segment_update = ((rows + 2 * cols) % 4).astype(np.int16)
    payload = jserialize(header, arrays, probs, True, 176, 144)
    chunk = UncompressedChunk(payload, 176, 144)
    state = DecoderState.initial(176, 144)
    pheader, parrays, pprobs = FrameParser(state).parse(chunk)
    assert pheader.update_segmentation.update_mb_segmentation_map
    assert serialize_frame(pheader, parrays, pprobs, True, 176,
                           144) == payload


class _FailingLib:
    """Every native entry reports failure."""

    def __getattr__(self, name):
        return lambda *args: 1


def test_native_serializer_failure_raises(monkeypatch):
    """A native writer's failure raises; nothing falls back to a Python
    writer."""
    ivf = IVFReader(str(FIXTURES / "kf_176x144_q16.ivf"))
    chunk = UncompressedChunk(ivf.frame(0), ivf.width, ivf.height)
    header, arrays, probs = FrameParser(
        DecoderState.initial(ivf.width, ivf.height)).parse(chunk)
    monkeypatch.setattr(bitwork, "_lib", _FailingLib())
    with pytest.raises(RuntimeError, match="vp8_write_flagged_literals"):
        serialize_frame(header, arrays, probs, True, ivf.width, ivf.height)
    with pytest.raises(RuntimeError, match="vp8_serialize_tokens"):
        bitwork.serialize_tokens(arrays, probs.coeff_probs, 1)
    with pytest.raises(RuntimeError, match="vp8_count_token_branches"):
        bitwork.count_token_branches(arrays)
    with pytest.raises(RuntimeError, match="vp8_write_kf_modes"):
        bitwork.write_kf_modes(BoolEncoder(), arrays, header.prob_skip_false)


# ------------------------------------------------------------------ SSIM

def test_ssim_sums_serially_like_the_c_loop():
    """The port's SSIM equals the JAX package's C SSIM to the bit at 720p,
    where a pairwise mean of the same window ratios rounds differently."""
    from alfalfa_tpu.native import lfkernel
    assert lfkernel.available()
    rng = np.random.default_rng(11)
    vals = rng.uniform(0.5, 1.0, 179 * 319)
    acc = 0.0
    for v in vals.tolist():
        acc += v
    assert serial_mean(vals) == acc / vals.size != vals.mean()
    orig = rng.integers(0, 256, (720, 1280), dtype=np.uint8)
    noise = rng.integers(-6, 7, (3, 720, 1280))
    cands = np.clip(orig + noise, 0, 255).astype(np.uint8)
    got = ssim(t(cands), t(orig)).tolist()
    assert got == [lfkernel.ssim(c, orig) for c in cands]


# ------------------------------------------------------------------ slow

@pytest.mark.slow
def test_chip_smoke_digests_from_jax():
    """chip_smoke.KF_ENCODE_SHA1, recomputed with the JAX package: its
    FilePlayer decodes the 720p fixture (checked against the manifest), its
    host encoder encodes frames 0 and 3 as chip_smoke's keyframe_encode
    phase does.  A few minutes of CPU."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from alfalfa_tpu.decoder.decoder import FilePlayer as JFilePlayer
    clip = FIXTURES / "inter_1280x720_q48.ivf"
    digest, frames = hashlib.sha1(), []
    for raster in JFilePlayer(str(clip)):
        digest.update(raster.dump_bytes())
        frames.append(tuple(np.array(p) for p in raster.display()))
    with open(FIXTURES / "manifest.json") as fh:
        assert digest.hexdigest() == json.load(fh)[clip.name]["yuv_sha1"]
    got = {}
    for name, qi, two_pass in chip_smoke.KF_ENCODE_MODES:
        enc = JEncoder(1280, 720, two_pass=two_pass, device_encode=False)
        for k in (0, 3):
            got["%s_frame%d" % (name, k)] = hashlib.sha1(
                enc.encode_with_quantizer(frames[k], qi,
                                          key_frame=True)).hexdigest()
    enc = JEncoder(1280, 720, device_encode=False)
    got["min_ssim_%.2f_frame0" % chip_smoke.KF_MIN_SSIM] = hashlib.sha1(
        enc.encode_with_minimum_ssim(frames[0], chip_smoke.KF_MIN_SSIM,
                                     key_frame=True)).hexdigest()
    assert got == chip_smoke.KF_ENCODE_SHA1
