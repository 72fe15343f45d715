"""The interframe-encoder slice on the CPU, tolerance 0: the port's
``Encoder(device="cpu")`` (so K8 runs its plain version) against the JAX
package's host encoder ``Encoder(device_encode=False)``, whose per-macroblock
loop (encoder/encode_inter_np.py) the JAX package holds its TPU inter kernel
to (tests/test_device_inter.py):

- payloads and minihashes in best, rt and two-pass, partial edge
  macroblocks included, and through the size and SSIM searches;
- the fused quantizer pair against two sequential encodes of forks;
- K8's plain version against the host macroblock loop's FrameArrays and
  reconstruction, on a decoded-like frame and on seeded extreme motion
  whose vectors point far out of the frame;
- encoders carried between the packages mid-stream, and ``xc enc``.

No interpret-mode call of the TPU inter kernel.  On the card,
chip_smoke.py holds the CUDA kernel against the plain version and the
encoder's frames against INTER_ENCODE_SHA1.
"""
import hashlib
import json
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)    # many tiny ops: threads only add contention

from alfalfa_tpu.bitstream.header import QuantIndices as JQuantIndices
from alfalfa_tpu.cli import xc as jxc
from alfalfa_tpu.encoder import Encoder as JEncoder
from alfalfa_tpu.encoder import encode_inter_np
from alfalfa_tpu.state import decoder_state as JDS

from alfalfa_tpu_torch import convert
from alfalfa_tpu_torch.bitstream.header import QuantIndices
from alfalfa_tpu_torch.cli import xc
from alfalfa_tpu_torch.decoder import Decoder
from alfalfa_tpu_torch.encoder import Encoder
from alfalfa_tpu_torch.encoder import encode_inter as EI
from alfalfa_tpu_torch.ops import enc_inter, enc_inter_cuda
from alfalfa_tpu_torch.state.decoder_state import Raster
from alfalfa_tpu_torch.util.ivf import IVFReader

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures"
sys.path.insert(0, str(FIXTURES))
from gen_inputs import gen_clip, write_y4m  # noqa: E402
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402


def _both(w, h, quality="best", two_pass=False):
    return (JEncoder(w, h, device_encode=False, quality=quality,
                     two_pass=two_pass),
            Encoder(w, h, device="cpu", quality=quality, two_pass=two_pass))


# ------------------------------------------------------------ the tables

def test_inter_cost_tables_match_jax():
    """SAD per bit, the SAD mv costs (float32 log2) and the mv component
    costs under default and moved mv probabilities."""
    np.testing.assert_array_equal(EI.SAD_PER_BIT16,
                                  encode_inter_np.SAD_PER_BIT16)
    np.testing.assert_array_equal(EI._MV_SAD_COST,
                                  encode_inter_np._MV_SAD_COST)
    from alfalfa_tpu.bitstream import tables as JT
    probs = np.array(JT.DEFAULT_MV_PROBS)
    moved = probs.copy()
    moved[:, ::3] = np.clip(moved[:, ::3].astype(int) + 70, 1, 255)
    for p in (probs, moved):
        np.testing.assert_array_equal(
            EI.mv_component_costs(p),
            encode_inter_np.MVComponentCostTable(p).table)


# ------------------------------------------------- the Encoder, end to end

@pytest.mark.parametrize("quality,qi,size,two_pass", [
    ("best", 40, (80, 48), False),
    ("rt", 64, (80, 48), False),
    ("rt", 48, (76, 44), False),   # partial edge macroblocks
    ("best", 40, (80, 48), True),
    ("best", 72, (76, 44), True),
])
def test_interframes_byte_identical(quality, qi, size, two_pass):
    """A key frame and three interframes (the cases of
    tests/test_device_inter.py): payloads, minihashes and loop-filter
    levels after each."""
    w, h = size
    jenc, enc = _both(w, h, quality, two_pass)
    for i, f in enumerate(gen_clip(w, h, 4, seed=31)):
        p = enc.encode_with_quantizer(f, qi, key_frame=i == 0)
        assert p == jenc.encode_with_quantizer(f, qi, key_frame=i == 0), \
            "frame %d differs" % i
        assert enc.minihash() == jenc.minihash()
        assert enc.last_loop_filter_level == jenc.last_loop_filter_level
    assert enc.frame_no == 4


def test_fused_pair_matches_sequential_forks():
    """encode_interframe_multiqp (one K8 call, the quantizer a batch axis)
    against two forks each encoding the frame in turn, in the port and in
    the JAX host encoder; each fork's state advances by its own frame."""
    w, h = 80, 48
    clip = gen_clip(w, h, 3, seed=35)
    qis = (40, 72)
    jbase, base = _both(w, h, "rt")
    for e in (jbase, base):
        e.encode_with_quantizer(clip[0], 56, key_frame=True)
    jforks = [jbase.fork() for _ in qis]
    want = [e.encode_with_quantizer(clip[1], q) for e, q in zip(jforks, qis)]
    forks = [base.fork() for _ in qis]
    got = EI.encode_interframe_multiqp(
        forks, clip[1], [QuantIndices(y_ac_qi=q) for q in qis])
    for (payload, quality), w_, f, jf in zip(got, want, forks, jforks):
        assert payload == w_
        assert f.minihash() == jf.minihash()
        assert quality == jf.last_ssim
    assert forks[0].minihash() != forks[1].minihash() != base.minihash()
    # the next frame from each fork
    for f, jf in zip(forks, jforks):
        assert f.encode_with_quantizer(clip[2], 48) == \
            jf.encode_with_quantizer(clip[2], 48)
    with pytest.raises(ValueError, match="one-pass"):
        two = Encoder(w, h, device="cpu", two_pass=True)
        EI.encode_interframe_multiqp([two, two.fork()], clip[1],
                                     [QuantIndices(y_ac_qi=q) for q in qis])


def test_minimum_ssim_and_target_size_interframes():
    """The SSIM search (a K8 trial encode per step) and the size search
    (interframe trial encodes of the mosaic against mosaic references) on
    interframes."""
    w, h = 48, 32
    clip = gen_clip(w, h, 2, seed=7)
    jenc, enc = _both(w, h)
    for i, f in enumerate(clip):
        assert enc.encode_with_minimum_ssim(f, 0.9) == \
            jenc.encode_with_minimum_ssim(f, 0.9), "frame %d differs" % i
        assert enc.last_y_ac_qi == jenc.last_y_ac_qi
    assert enc.minihash() == jenc.minihash()

    w, h = 128, 96      # a 2 x 1 mosaic of an 8 x 6 frame
    big = gen_clip(w, h, 2, seed=8)
    jenc, enc = _both(w, h)
    for e in (jenc, enc):
        e.encode_with_quantizer(big[0], 40, key_frame=True)
    assert enc.estimate_frame_size(big[1], 40) == \
        jenc.estimate_frame_size(big[1], 40)
    assert enc.encode_with_target_size(big[1], 700) == \
        jenc.encode_with_target_size(big[1], 700)
    assert enc.last_y_ac_qi == jenc.last_y_ac_qi
    assert enc.minihash() == jenc.minihash()


# ----------------------------------------- K8's plain version, macroblocks

@pytest.mark.parametrize("case", ["clip two-pass", "extreme motion"])
def test_k8_plain_matches_host_loop(case, monkeypatch):
    """encode_inter_frame_plain against encode_inter_np.encode_interframe's
    macroblock loop on the same state: coefficients, modes, references,
    vectors, flags and the unfiltered reconstruction."""
    if case == "clip two-pass":
        w, h, qi, two_pass = 96, 64, 30, True
        clip = gen_clip(w, h, 2, seed=12)
        jenc, enc = _both(w, h, two_pass=True)
        for e in (jenc, enc):
            e.encode_with_quantizer(clip[0], qi, key_frame=True)
        frame = clip[1]
    else:
        w, h, qi, two_pass = 176, 96, 48, False
        last, frame = chip_smoke.extreme_motion_planes(3, w, h, 40)
        jenc, enc = _both(w, h)
        jenc.references.last = JDS.Raster(w, h, *last)
        enc.references.last = Raster(w, h, *(torch.from_numpy(p)
                                              for p in last))
    seen = {}
    monkeypatch.setattr(encode_inter_np, "finish_interframe",
                        lambda e, hd, arrays, recon, *a: seen.update(
                            arrays=arrays, recon=recon))
    encode_inter_np.encode_interframe(jenc, frame,
                                      JQuantIndices(y_ac_qi=qi), False)
    ja, jr = seen["arrays"], seen["recon"]
    args = EI.kernel_inputs(enc, frame, [QuantIndices(y_ac_qi=qi)])
    co, md, y, u, v = enc_inter_cuda.encode_inter_frame(*args)
    a = EI._outputs_to_frame(co[0].numpy(), md[0].numpy(), *ja.ymode.shape)
    for k in ("coeffs", "ymode", "uvmode", "ref", "bmode", "sub_mv", "uv_mv",
              "y2_coded", "has_nonzero"):
        np.testing.assert_array_equal(getattr(a, k), getattr(ja, k), err_msg=k)
    for got, want in zip((y[0], u[0], v[0]), (jr.y, jr.u, jr.v)):
        np.testing.assert_array_equal(got.numpy(), want)
    md = md[0]
    n_intra = int((md[..., 2] == 0).sum())
    if case == "clip two-pass":
        assert 0 < n_intra and (md[..., 0] == enc_inter.NEWMV).any()
    else:
        newmv = md[..., 0] == enc_inter.NEWMV
        assert md[..., 4:6][newmv].abs().max() >= 300     # far moves
        # some final vectors (not clamped) reach further out of the frame
        # than the clamp lets any other vector: more than 16 pixels
        R, C = md.shape[:2]
        x = torch.arange(C) * 128 + md[..., 4]
        y = torch.arange(R)[:, None] * 128 + md[..., 5]
        out = (x < -128) | (x > (C - 1) * 128 + 128) | (y < -128) \
            | (y > (R - 1) * 128 + 128)
        assert out[newmv].any()
        assert (md[..., enc_inter.SITES] > 0).all()
    # the counts the chip's bound reads: ZERO always scored, at most four
    # candidates; an inter winner's own prediction is among the taps
    cands, taps = md[..., enc_inter.CANDS], md[..., enc_inter.TAPS]
    assert ((cands >= 1) & (cands <= 4)).all() and (taps % 96 == 0).all()
    inter = md[..., 2] != 0
    own = enc_inter.luma_taps(md[..., 4] & 7, md[..., 5] & 7)
    assert (taps[inter] >= own[inter]).all() and (taps > 0).any()


def test_k8_prediction_far_outside_the_frame():
    """The six-tap prediction at vectors far outside the plane (clamped per
    index) against the host loop's _inter_predict_into."""
    rng = np.random.default_rng(9)
    plane = rng.integers(0, 256, (48, 64), dtype=np.uint8)
    mvs = [(-8 * 300 + 3, 8 * 200 + 5), (8 * 150 + 7, -8 * 140 - 1),
           (1023 + 10240, -1023), (0, 5), (-9, 0)]
    r = torch.tensor([0, 2, 1, 0, 2])
    c = torch.tensor([3, 0, 1, 0, 3])
    mx = torch.tensor([m[0] for m in mvs])
    my = torch.tensor([m[1] for m in mvs])
    got = enc_inter.predict_mbs(torch.from_numpy(plane), r, c, mx, my, 16)
    out = np.zeros((16, 16), np.uint8)
    for i, mv in enumerate(mvs):
        encode_inter_np._inter_predict_into(plane, out, int(c[i]) * 16,
                                            int(r[i]) * 16, 16, mv)
        np.testing.assert_array_equal(got[i].numpy(), out)


def test_k8_wrapper_takes_plain_version_only_on_cpu():
    w, h = 48, 32
    clip = gen_clip(w, h, 2, seed=4)
    enc = Encoder(w, h, device="cpu", quality="rt")
    enc.encode_with_quantizer(clip[0], 40, key_frame=True)
    args = EI.kernel_inputs(enc, clip[1], [QuantIndices(y_ac_qi=40)])
    before = enc_inter_cuda.launches
    for a, b in zip(enc_inter_cuda.encode_inter_frame(*args),
                    enc_inter.encode_inter_frame_plain(*args)):
        assert torch.equal(a, b)
    assert enc_inter_cuda.launches == before


# ------------------------------------------------- carry, decode, the CLI

def test_carry_mid_stream_both_ways():
    """An encoder carried after interframes, JAX -> port and port -> JAX
    (convert.encoder_to_dict / encoder_from_dict), makes the next
    interframe byte-identical; the port's Decoder decodes the port's
    stream to the encoder's minihash."""
    w, h = 64, 48
    clip = gen_clip(w, h, 4, seed=41)
    jenc, enc = _both(w, h, "rt")
    dec = Decoder(w, h, device="cpu")
    for i, f in enumerate(clip[:3]):
        p = enc.encode_with_quantizer(f, 44)
        assert p == jenc.encode_with_quantizer(f, 44)
        dec.decode_frame(p)
    assert dec.minihash() == enc.minihash() == jenc.minihash()
    port = convert.encoder_from_dict(convert.encoder_to_dict(jenc),
                                     device="cpu")
    back = convert.encoder_from_dict(convert.encoder_to_dict(enc),
                                     encoder_cls=JEncoder, classes=JDS)
    want = jenc.encode_with_quantizer(clip[3], 44)
    assert port.encode_with_quantizer(clip[3], 44) == want
    assert back.encode_with_quantizer(clip[3], 44) == want
    assert port.minihash() == back.minihash() == jenc.minihash()
    assert port.last_loop_filter_level == jenc.last_loop_filter_level


@pytest.mark.parametrize("mode", [["--y-ac-qi", "36", "-q", "rt"], []])
def test_xc_enc_matches_jax(mode, tmp_path):
    """``xc enc --device cpu`` against the JAX package's ``xc enc``: the IVF
    and the -O state file byte for byte, in constant-quantizer mode and in
    the default SSIM mode; then -I continues a chunk from the state."""
    w, h = 48, 32
    y4m = tmp_path / "in.y4m"
    write_y4m(str(y4m), gen_clip(w, h, 2, seed=17), w, h)
    for name, main, extra in (("jax", jxc.main, []),
                              ("port", xc.main, ["--device", "cpu"])):
        main(["enc", str(y4m), "-o", str(tmp_path / (name + ".ivf")),
              "-O", str(tmp_path / (name + ".state"))] + mode + extra)
    for ext in (".ivf", ".state"):
        assert (tmp_path / ("port" + ext)).read_bytes() == \
            (tmp_path / ("jax" + ext)).read_bytes(), ext
    if mode:
        for name, main, extra in (("jax", jxc.main, []),
                                  ("port", xc.main, ["--device", "cpu"])):
            main(["enc", str(y4m), "-o", str(tmp_path / (name + "2.ivf")),
                  "-I", str(tmp_path / (name + ".state"))] + mode + extra)
        assert (tmp_path / "port2.ivf").read_bytes() == \
            (tmp_path / "jax2.ivf").read_bytes()


@pytest.mark.slow
def test_xc_enc_target_size_offgrid_matches_jax(tmp_path):
    """``xc enc -F --device cpu`` at 360x242 against the JAX package's ``xc
    enc -F``: a key frame and two interframes of natural/cut_360x242_q56.ivf
    (a 4 x 5 macroblock mosaic cut from a frame of partial macroblocks),
    the IVF byte for byte, at the first three of chip_smoke.py's targets
    for it.  About a minute (the port's trial encodes on the CPU)."""
    import itertools
    from alfalfa_tpu.decoder.decoder import FilePlayer as JFilePlayer
    frames = [tuple(np.array(p) for p in r.display()) for r in
              itertools.islice(JFilePlayer(chip_smoke.OFFGRID_CLIP), 3)]
    h, w = frames[0][0].shape
    y4m, sizes = tmp_path / "in.y4m", tmp_path / "sizes"
    chip_smoke.write_y4m(str(y4m), frames, w, h)
    sizes.write_text("".join("%d\n" % n for n in
                             chip_smoke.TARGET_SIZES["360x242"][:3]))
    for name, main, extra in (("jax", jxc.main, []),
                              ("port", xc.main, ["--device", "cpu"])):
        assert main(["enc", str(y4m), "-o", str(tmp_path / (name + ".ivf")),
                     "-F", str(sizes)] + extra) is None
    got = (tmp_path / "port.ivf").read_bytes()
    assert got == (tmp_path / "jax.ivf").read_bytes()
    assert [hashlib.sha1(p).hexdigest() for p in
            IVFReader(str(tmp_path / "port.ivf"))] == [
        chip_smoke.TARGET_SIZE_SHA1["360x242_best_frame%d" % k]
        for k in range(3)]


# ------------------------------------------------------------------ slow

@pytest.mark.slow
def test_chip_smoke_inter_digests_from_jax():
    """chip_smoke.INTER_ENCODE_SHA1, recomputed with the JAX package: its
    FilePlayer decodes the 720p fixture (checked against the manifest), its
    host encoder encodes frames 0-5 as chip_smoke's inter_encode phase
    does, the pair as two forks.  Several minutes of CPU."""
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
    for name, qi, quality, two_pass in chip_smoke.INTER_ENCODE_MODES:
        enc = JEncoder(1280, 720, quality=quality, two_pass=two_pass,
                       device_encode=False)
        for k, label in enumerate(chip_smoke.inter_labels(name)):
            got[label] = sha(enc.encode_with_quantizer(frames[k], qi,
                                                       key_frame=k == 0))
    enc = JEncoder(1280, 720, device_encode=False)
    for k, label in enumerate(chip_smoke.inter_labels("min_ssim")):
        got[label] = sha(enc.encode_with_minimum_ssim(
            frames[k], chip_smoke.INTER_MIN_SSIM, key_frame=k == 0))
    enc = JEncoder(1280, 720, quality="rt", device_encode=False)
    labels = chip_smoke.inter_labels("pair")
    got[labels[0]] = sha(enc.encode_with_quantizer(
        frames[0], chip_smoke.INTER_PAIR_KEY_QI, key_frame=True))
    forks = [enc.fork() for _ in chip_smoke.INTER_PAIR_QIS]
    for label, f, q in zip(labels[1:], forks, chip_smoke.INTER_PAIR_QIS):
        got[label] = sha(f.encode_with_quantizer(frames[1], q))
    assert got == chip_smoke.INTER_ENCODE_SHA1


def jax_target_size_digests(work, clips=None, trials=None):
    """chip_smoke.TARGET_SIZE_SHA1 from the JAX package, as the comment
    above it describes: its FilePlayer decodes frames 0-5 of each clip
    into a y4m file in ``work``; its ``xc enc -F`` encodes them in best
    and rt; for --fast its encoder is set up as its CLI's --fast sets it
    up, the key frame on the host (whose frames equal its key-frame
    kernel's: tests/test_device_encode.py) and the interframes with their
    trial encodes on its fast path (test_torch_fast_inter.jax_fast_path,
    for the frame's and the mosaic's shapes).  ``trials``, a list, gets
    (clip, mode, quantizer, estimate) for every trial encode."""
    import itertools
    from alfalfa_tpu.decoder.decoder import FilePlayer as JFilePlayer
    from alfalfa_tpu.util.ivf import IVFReader as JIVFReader
    from test_torch_fast_inter import jax_fast_path
    cs = chip_smoke
    estimate = JEncoder.estimate_frame_size
    where = [None, None]

    def logged(self, yuv, y_ac_qi, key_frame=None):
        n = estimate(self, yuv, y_ac_qi, key_frame)
        if trials is not None:
            trials.append((*where, int(y_ac_qi), n))
        return n

    JEncoder.estimate_frame_size = logged
    got = {}
    try:
        for name, path in cs.TARGET_SIZE_CLIPS:
            if clips is not None and name not in clips:
                continue
            frames = [tuple(np.array(p) for p in r.display()) for r in
                      itertools.islice(JFilePlayer(str(path)),
                                       cs.TARGET_SIZE_FRAMES)]
            h, w = frames[0][0].shape
            y4m, sizes = work / (name + ".y4m"), work / (name + ".sizes")
            cs.write_y4m(str(y4m), frames, w, h)
            sizes.write_text("".join("%d\n" % n
                                     for n in cs.TARGET_SIZES[name]))
            for mode, flags in cs.TARGET_SIZE_MODES:
                where[:] = name, mode
                if "--fast" in flags:
                    e = JEncoder(w, h, quality="rt", device_encode=False)
                    R, C = e.mb_rows, e.mb_cols
                    with jax_fast_path(R, C, (max(1, R // 4),
                                              max(1, C // 4))):
                        pls = []
                        for k, f in enumerate(frames):
                            pls.append(e.encode_with_target_size(
                                f, cs.TARGET_SIZES[name][k]))
                            e.device_encode = True
                else:
                    out = work / ("%s_%s.ivf" % (name, mode))
                    assert jxc.main(["enc", str(y4m), "-o", str(out), "-F",
                                     str(sizes)] + list(flags)) is None
                    pls = list(JIVFReader(str(out)))
                got.update(zip(cs.target_size_labels(name, mode),
                               (hashlib.sha1(p).hexdigest() for p in pls)))
    finally:
        JEncoder.estimate_frame_size = estimate
    return got


@pytest.mark.slow
def test_chip_smoke_target_size_digests_from_jax(tmp_path):
    """chip_smoke.TARGET_SIZE_SHA1, recomputed with the JAX package (about
    ten minutes of CPU, most of it the 720p frames)."""
    assert jax_target_size_digests(tmp_path) == chip_smoke.TARGET_SIZE_SHA1
