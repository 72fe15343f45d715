"""The fast path's host-patch variant on the CPU, tolerance 0: the port's
``Encoder(quality="rt", fast=True, fast_bpred=True, device="cpu")``
against the JAX package's fast path with ``ALFALFA_FAST_FIXUP=0`` and
``ALFALFA_FAST_BPRED=1``, both deterministic integer code, so held byte
for byte:

- native/enckernel.cc's B_PRED search and 4x4 prediction against their
  numpy bodies and the JAX package's enckernel;
- the host intra encoder of one macroblock (encode_intra_np.encode_intra_mb)
  against the JAX package's, key frame and interframe;
- whole streams at 80x48 over a scene cut, single frames (no K10 call)
  and the Salsify pair (K10 once a call, patched over, as in the JAX
  package), with at least one host-patched macroblock.

The JAX side's fast kernels run under one ``jax.jit`` each
(test_torch_fast_inter.jax_fast_path); its environment switches are set
for the JAX package only.
"""
import contextlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from alfalfa_tpu.bitstream.header import QuantIndices as JQuantIndices  # noqa: E402
from alfalfa_tpu.decoder.parse import FrameArrays as JFrameArrays  # noqa: E402
from alfalfa_tpu.encoder import Encoder as JEncoder  # noqa: E402
from alfalfa_tpu.encoder import encode_inter_fast as JEIF  # noqa: E402
from alfalfa_tpu.encoder import encode_intra_np as JEIN  # noqa: E402
from alfalfa_tpu.native import enckernel as JEK  # noqa: E402
from alfalfa_tpu.state.decoder_state import Raster as JRaster  # noqa: E402

from alfalfa_tpu_torch.bitstream.header import QuantIndices  # noqa: E402
from alfalfa_tpu_torch.decoder import Decoder  # noqa: E402
from alfalfa_tpu_torch.decoder.parse import FrameArrays  # noqa: E402
from alfalfa_tpu_torch.encoder import Encoder  # noqa: E402
from alfalfa_tpu_torch.encoder import encode_inter_fast as EIF  # noqa: E402
from alfalfa_tpu_torch.encoder import encode_intra_np as EIN  # noqa: E402
from alfalfa_tpu_torch.encoder.costs import rd_multipliers  # noqa: E402
from alfalfa_tpu_torch.native import enckernel  # noqa: E402
from alfalfa_tpu_torch.ops import enc_intra_fixup_cuda  # noqa: E402
from alfalfa_tpu_torch.state.decoder_state import Raster  # noqa: E402

from test_torch_fast_inter import _jitted, gen_clip, jax_fast_path  # noqa: E402

W, H = 80, 48
R, C = H // 16, W // 16


def _planes(rng, w=W, h=H):
    return (rng.integers(0, 256, (h, w)).astype(np.uint8),
            rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8),
            rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8))


def test_bpred_kernels_match_plain_and_jax():
    """bpred_search and bpred_predict at every 4x4 position of a random
    80x48 plane (every above-right edge rule), every mode, three RD
    weightings, against their numpy bodies and the JAX package's
    enckernel; the plane is never written.  Tolerance 0."""
    assert JEK.available()
    rng = np.random.default_rng(3)
    plane = rng.integers(0, 256, (H, W)).astype(np.uint8)
    keep = plane.copy()
    jpred = np.empty((4, 4), np.uint8)
    for row4 in range(H // 4):
        for col4 in range(W // 4):
            for m in range(10):
                got = enckernel.bpred_predict(plane, col4, row4, m)
                np.testing.assert_array_equal(
                    got, EIN.bpred_predict_plain(plane, col4, row4, m))
                JEK._lib.vp8_bpred_predict(plane.ctypes.data, H, W, W, col4,
                                           row4, m, jpred.ctypes.data)
                np.testing.assert_array_equal(got, jpred)
            orig = rng.integers(0, 256, (4, 4)).astype(np.uint8)
            costs = rng.integers(0, 4000, 10)
            for rm, dm in ((716, 1), (26, 100), (3, 100)):
                m, pred = enckernel.bpred_search(plane, col4, row4, orig,
                                                 costs, rm, dm)
                pm, ppred = EIN.bpred_search_plain(plane, col4, row4, orig,
                                                   costs, rm, dm)
                jm, jp = JEK.bpred_search(plane, col4, row4, orig, costs,
                                          rm, dm)
                assert m == pm == jm
                np.testing.assert_array_equal(pred, ppred)
                np.testing.assert_array_equal(pred, jp)
    np.testing.assert_array_equal(plane, keep)
    with pytest.raises(ValueError, match="uint8"):
        enckernel.bpred_predict(plane.astype(np.int16), 0, 0, 0)


def test_encode_intra_mb_matches_jax():
    """encode_intra_mb over every macroblock of an 80x48 frame in raster
    order, each against the reconstruction the earlier ones left (a random
    one to start), as a key frame and as an interframe, at two
    quantizers: the arrays and the reconstruction equal the JAX package's
    host encoder's, and B_PRED wins somewhere.  Tolerance 0."""
    rng = np.random.default_rng(11)
    orig = _planes(rng)
    start = _planes(rng)
    bpred_won = 0
    for qi in (20, 90):
        q = {k: int(v) for k, v in
             QuantIndices(y_ac_qi=qi).quantizer().items()}
        rm, dm = rd_multipliers(q["y_ac"])
        for interframe in (False, True):
            got, want = FrameArrays(R, C), JFrameArrays(R, C)
            rec = Raster(W, H, *(p.copy() for p in start))
            jrec = JRaster(W, H, *(p.copy() for p in start))
            for r in range(R):
                for c in range(C):
                    EIN.encode_intra_mb(orig, rec, got, r, c, q, rm, dm,
                                        interframe=interframe)
                    JEIN.encode_intra_mb(orig, jrec, want, r, c, q, rm, dm,
                                         interframe=interframe)
            for k in ("ymode", "uvmode", "bmode", "coeffs", "y2_coded",
                      "has_nonzero", "ref"):
                np.testing.assert_array_equal(getattr(got, k),
                                              getattr(want, k), k)
            for p in ("y", "u", "v"):
                np.testing.assert_array_equal(getattr(rec, p),
                                              getattr(jrec, p), p)
            bpred_won += int((got.ymode == 4).sum())
    assert bpred_won > 0


def _scene_cut_clip():
    """Frames 0-2 of one synthetic clip, then frames 0-2 of another: the
    jump at frame 3 is a scene cut, where K9 scores macroblocks intra."""
    return gen_clip(W, H, 3, seed=7) + gen_clip(W, H, 3, seed=41)[::-1]


@contextlib.contextmanager
def jax_patch_path(mb_rows=R, mb_cols=C):
    """test_torch_fast_inter.jax_fast_path with the JAX package's host-patch
    variant: ALFALFA_FAST_FIXUP=0, ALFALFA_FAST_BPRED=1 and _fast_raw
    without the fixup, under one jax.jit.  Its pair keeps its vmapped
    _fast_raw, which always runs the fixup: the host patch then re-encodes
    every intra macroblock over it."""
    nofix = _jitted("nofix", mb_rows, mb_cols, lambda: JEIF._fast_raw(
        mb_rows, mb_cols, True, False, False))
    env = {"ALFALFA_FAST_FIXUP": "0", "ALFALFA_FAST_BPRED": "1"}
    saved_env = {k: os.environ.get(k) for k in env}
    with jax_fast_path(mb_rows, mb_cols):
        saved = JEIF._fast_fn
        JEIF._fast_fn = lambda *a: nofix
        os.environ.update(env)
        try:
            yield
        finally:
            JEIF._fast_fn = saved
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v


def _no_k10(monkeypatch):
    monkeypatch.setattr(enc_intra_fixup_cuda, "intra_fixup_frame_plain",
                        lambda *a: pytest.fail("the host patch ran K10"))


def test_fast_patch_stream_matches_jax(monkeypatch):
    """A key frame and five host-patch fast interframes over a scene cut
    at 80x48, qi 48, the first a loop-filter re-climb and the rest steady:
    payloads, minihashes, loop-filter levels and LAST equal the JAX
    package's frames under ALFALFA_FAST_FIXUP=0 and ALFALFA_FAST_BPRED=1;
    every frame re-decodes to the encoder's minihash; K10 never runs, and
    macroblocks are patched on the host.  Tolerance 0."""
    _no_k10(monkeypatch)
    enc = Encoder(W, H, quality="rt", fast=True, fast_bpred=True,
                  device="cpu")
    dec = Decoder(W, H, device="cpu")
    patched = []
    with jax_patch_path():
        jenc = JEncoder(W, H, quality="rt", device_encode=False)
        for i, f in enumerate(_scene_cut_clip()):
            p = enc.encode_with_quantizer(f, 48, key_frame=i == 0)
            assert p == jenc.encode_with_quantizer(f, 48, key_frame=i == 0), \
                "frame %d differs" % i
            jenc.device_encode = True
            assert enc.minihash() == jenc.minihash()
            assert enc.last_loop_filter_level == jenc.last_loop_filter_level
            np.testing.assert_array_equal(enc.references.last.y.numpy(),
                                          np.asarray(jenc.references.last.y))
            dec.decode_frame(p)
            assert dec.minihash() == enc.minihash()
            if i:
                patched.append(enc.patched_mbs)
    assert sum(patched) > 0, patched


def test_fast_patch_pair_matches_jax(monkeypatch):
    """The Salsify pair (qi 60 and 110) through
    encode_interframe_fast_multiqp in the host-patch variant, on the
    interframe after the key frame: each payload and minihash equals the
    JAX package's pair under ALFALFA_FAST_FIXUP=0 and ALFALFA_FAST_BPRED=1,
    and re-decodes to its encoder's minihash.  Like the JAX pair, the
    port's runs K10 once a call and patches over it, so a macroblock that
    takes B_PRED keeps K10's Y2 block: at qi 110 that makes the payload
    differ from the single encode of a fork, which runs no K10 (asserted,
    so the test is not vacuous).  Tolerance 0."""
    qis = (60, 110)
    kf_frame, f = _scene_cut_clip()[:2]
    k10 = [0]
    plain = enc_intra_fixup_cuda.intra_fixup_frame_plain

    def counted(*a):
        k10[0] += 1
        return plain(*a)

    monkeypatch.setattr(enc_intra_fixup_cuda, "intra_fixup_frame_plain",
                        counted)
    base = Encoder(W, H, quality="rt", fast=True, fast_bpred=True,
                   device="cpu")
    kf = base.encode_with_quantizer(kf_frame, 56, key_frame=True)
    forks = [base.fork() for _ in qis]
    singles = [base.fork() for _ in qis]
    got = EIF.encode_interframe_fast_multiqp(
        forks, f, [QuantIndices(y_ac_qi=q) for q in qis])
    assert k10[0] == 1
    with jax_patch_path():
        jbase = JEncoder(W, H, quality="rt", device_encode=False)
        assert kf == jbase.encode_with_quantizer(kf_frame, 56, key_frame=True)
        jbase.device_encode = True
        jforks = [jbase.fork() for _ in qis]
        want = JEIF.encode_interframe_fast_multiqp(
            jforks, f, [JQuantIndices(y_ac_qi=q) for q in qis],
            interpret=True)
    dec = Decoder(W, H, device="cpu")
    dec.decode_frame(kf)
    for (p, _), (jp, _), fk, jfk, q in zip(got, want, forks, jforks, qis):
        assert p == jp, "qi %d differs" % q
        assert fk.minihash() == jfk.minihash()
        d = dec.copy()
        d.decode_frame(p)
        assert d.minihash() == fk.minihash()
    assert sum(fk.patched_mbs for fk in forks) > 0
    single = [s.encode_with_quantizer(f, q) for s, q in zip(singles, qis)]
    assert k10[0] == 1
    assert single[1] != got[1][0]


# ------------------------------------------------------------ slow

def jax_patch_digests():
    """chip_smoke.FAST_PATCH_SHA1 from the JAX package: its FilePlayer
    decodes frames 0-5 of the 720p fixture; its rt encoder under
    ALFALFA_FAST_FIXUP=0 and ALFALFA_FAST_BPRED=1 encodes the key frame on
    the host, then the fast interframes of chip_smoke.FAST_ORDER, and the
    pair as two forks each through encode_interframe_fast_multiqp."""
    import hashlib
    import chip_smoke
    from alfalfa_tpu.decoder.decoder import FilePlayer as JFilePlayer
    from test_torch_fast_inter import FIXTURES
    frames = []
    for raster in JFilePlayer(str(FIXTURES / "inter_1280x720_q48.ivf")):
        frames.append(tuple(np.array(p) for p in raster.display()))
        if len(frames) == 6:
            break
    sha = lambda p: hashlib.sha1(p).hexdigest()
    got = {}
    with jax_patch_path(45, 80):
        enc = JEncoder(1280, 720, quality="rt", device_encode=False)
        for i, (label, k) in enumerate(zip(chip_smoke.patch_labels(),
                                           (0,) + chip_smoke.FAST_ORDER)):
            got[label] = sha(enc.encode_with_quantizer(
                frames[k], chip_smoke.FAST_QI, key_frame=i == 0))
            enc.device_encode = True
        labels = iter(chip_smoke.patch_labels(pair=True))
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
def test_chip_smoke_patch_digests_from_jax():
    """chip_smoke.FAST_PATCH_SHA1, recomputed with the JAX package (minutes
    of CPU)."""
    import chip_smoke
    assert jax_patch_digests() == chip_smoke.FAST_PATCH_SHA1
