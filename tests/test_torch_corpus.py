"""The corpus through the port's decoders, distinct streams side by side,
and the JAX package's digests that chip_smoke.py holds the card to.

Tier 1 has one item: the 14 QCIF clips of 12 frames of
``tests/fixtures/natural_manifest.json`` decoded as one
``BatchedGopDecoder(G=14, device="cpu")`` batch, each GOP a different
clip, and the three clips off the 16-pixel grid (90x48, 140x96, 360x242)
through a G=1 batch and ``FilePlayer(device="cpu")``, each against its
manifest SHA-1; and the four feature streams at 170x138 through the
port's ``FilePlayer`` against the JAX package's, frame by frame.

Under ``-m slow``:
- the whole corpus as chip_smoke.py's corpus_decode phase groups it
  (``alfalfa_tpu_torch/tools/corpus.py``), under the scalar token parser
  and, where the host has AVX-512, the SIMD engine, and through
  ``FilePlayer``;
- the four feature streams of ``alfalfa_tpu_torch/tools/feature_streams.py``
  through both port decoders, alone and as one G=4 batch, against the JAX
  package's ``FilePlayer`` frame by frame, and ``chip_smoke.FEATURE_SHA1``
  and ``XC_DECODE_Y4M_SHA1`` recomputed from the JAX package;
- the feature streams at 170x138 through a G=1 GOP decoder, one G=4
  batch under each token engine and ``xc decode``, against
  ``chip_smoke.FEATURE_OFFGRID_SHA1``;
- ``chip_smoke.OFFGRID_ENCODE_SHA1`` recomputed from the JAX package (its
  host encoder, its fast path with the Pallas kernels in interpret mode
  under one ``jax.jit`` each, its host ``reencode``);
- ``alfalfa_tpu_torch/tools/corrupted_streams.json`` against the JAX
  package's concealing ``Decoder`` on its numpy backend, all 64 streams.
"""
import hashlib
import json
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)    # many tiny ops: threads only add contention

from alfalfa_tpu.bitstream.header import \
    QuantIndices as JQuantIndices                        # noqa: E402
from alfalfa_tpu.bitstream.header import \
    UncompressedChunk as JUncompressedChunk              # noqa: E402
from alfalfa_tpu.cli import xc as jxc                    # noqa: E402
from alfalfa_tpu.decoder.decoder import Decoder as JDecoder  # noqa: E402
from alfalfa_tpu.decoder.decoder import FilePlayer as JFilePlayer  # noqa: E402
from alfalfa_tpu.decoder.parse import FrameParser as JFrameParser  # noqa: E402
from alfalfa_tpu.encoder import Encoder as JEncoder      # noqa: E402
from alfalfa_tpu.encoder import encode_inter_fast as JEIF  # noqa: E402
from alfalfa_tpu.encoder import reencode as JRB          # noqa: E402
from alfalfa_tpu.state.decoder_state import \
    DecoderState as JDecoderState                        # noqa: E402

from alfalfa_tpu_torch.cli import xc                     # noqa: E402
from alfalfa_tpu_torch.native import bitwork             # noqa: E402
from alfalfa_tpu_torch.tools import corpus, feature_streams, \
    sanitize_fuzz                                        # noqa: E402
from alfalfa_tpu_torch.util.ivf import IVFReader         # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures"
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

OFFGRID = ("pan_90x48_q40.ivf", "zoom_140x96_q48.ivf", "cut_360x242_q56.ivf")


def _sha(payload):
    return hashlib.sha1(payload).hexdigest()


def _jax_frames(path):
    """Each shown frame's SHA-1 as the JAX package's FilePlayer decodes
    the file."""
    return [_sha(r.dump_bytes()) for r in JFilePlayer(str(path))]


def test_distinct_gops_and_offgrid_clips_match_manifest(tmp_path):
    """G=14 distinct QCIF clips in one batch, and the three clips off the
    grid through a G=1 batch and FilePlayer: every clip's manifest SHA-1
    (the port alone, on the CPU).  The four feature streams at 170x138
    (partial macroblocks at the right and the bottom: vectors counted and
    clamped on the rounded-up grid, references read past the edge) through
    the port's FilePlayer, frame by frame equal to the JAX package's
    FilePlayer on the same bytes and to chip_smoke.FEATURE_OFFGRID_SHA1."""
    groups = corpus.groups()
    qcif = groups[0]
    assert (qcif.width, qcif.height, len(qcif.clips),
            len(qcif.pattern)) == (176, 144, 14, 12)
    assert corpus.decode_batch(qcif, "cpu") == \
        [c.yuv_sha1 for c in qcif.clips]
    clips = {c.name: (g, c) for g in groups for c in g.clips}
    for name in OFFGRID:
        g, clip = clips[name]
        assert len(g.clips) == 1 and (g.width % 16 or g.height % 16), name
        assert corpus.decode_batch(g, "cpu") == [clip.yuv_sha1], name
        assert corpus.play(clip.path, "cpu") == clip.yuv_sha1, name
    paths = feature_streams.write_all(str(tmp_path), device="cpu",
                                      size=feature_streams.OFFGRID_SIZE)
    for name, path in paths.items():
        got = corpus.play(path, "cpu", per_frame=True)
        assert got == _jax_frames(path), name
        assert got == chip_smoke.FEATURE_OFFGRID_SHA1[name], name


# ------------------------------------------------------------------ slow

@pytest.mark.slow
def test_whole_corpus_through_both_decoders():
    """chip_smoke.py's corpus_decode batches on the CPU: every group of
    the natural corpus (and the 720p fixture beside its three 720p clips)
    as one batch of distinct GOPs under each token engine, and every clip
    through FilePlayer."""
    groups = corpus.groups(chip_smoke.CORPUS_EXTRA)
    clips = [c for g in groups for c in g.clips]
    assert len(clips) == 32
    assert [len(g.clips) for g in groups] == [14, 5, 4, 4, 2, 1, 1, 1]
    engines = ["scalar"] + (["simd"] if bitwork.simd_supported() else [])
    for engine in engines:
        for g in groups:
            assert corpus.decode_batch(g, "cpu", engine) == \
                [c.yuv_sha1 for c in g.clips], (engine, g.width, g.height)
    for c in clips:
        assert corpus.play(c.path, "cpu") == c.yuv_sha1, c.name


@pytest.mark.slow
def test_feature_streams_match_jax(tmp_path):
    """The port's generator's streams through FilePlayer, a G=1 GOP
    decoder and one G=4 batch over their first frames, frame by frame
    against the JAX package's FilePlayer; that is chip_smoke.FEATURE_SHA1.
    The JAX package's xc decode of the 360x242 clip is
    chip_smoke.XC_DECODE_Y4M_SHA1, as is the port's."""
    paths = feature_streams.write_all(str(tmp_path), device="cpu")
    clips = []
    for name, path in paths.items():
        want = _jax_frames(path)
        assert want == chip_smoke.FEATURE_SHA1[name], name
        one = corpus.alone(path)
        clips += one.clips
        assert corpus.play(path, "cpu", per_frame=True) == want, name
        assert corpus.decode_batch(one, "cpu", per_frame=True) == [want], \
            name
    n = chip_smoke.FEATURE_BATCH_FRAMES
    batch = corpus.Group(176, 144, corpus.frame_pattern(clips[0].payloads[:n]),
                         clips)
    assert corpus.decode_batch(batch, "cpu", frames=n, per_frame=True) == \
        [chip_smoke.FEATURE_SHA1[c.name][:n] for c in clips]
    jax_y4m, port_y4m = tmp_path / "jax.y4m", tmp_path / "port.y4m"
    jxc.main(["decode", chip_smoke.OFFGRID_CLIP, str(jax_y4m)])
    xc.main(["decode", chip_smoke.OFFGRID_CLIP, str(port_y4m), "--device",
             "cpu"])
    for out in (jax_y4m, port_y4m):
        assert _sha(out.read_bytes()) == chip_smoke.XC_DECODE_Y4M_SHA1


@pytest.mark.slow
def test_offgrid_feature_streams_through_both_decoders(tmp_path):
    """The streams at 170x138 through a G=1 GOP decoder each, one G=4
    batch over their first frames under each token engine, and xc decode,
    frame by frame against chip_smoke.FEATURE_OFFGRID_SHA1 (the JAX
    package's FilePlayer's: the tier-1 item above)."""
    size = feature_streams.OFFGRID_SIZE
    paths = feature_streams.write_all(str(tmp_path), device="cpu", size=size)
    want = chip_smoke.FEATURE_OFFGRID_SHA1
    clips = []
    for name, path in paths.items():
        one = corpus.alone(path)
        clips += one.clips
        assert corpus.decode_batch(one, "cpu", per_frame=True) == \
            [want[name]], name
        y4m = tmp_path / (name + ".y4m")
        xc.main(["decode", path, str(y4m), "--device", "cpu"])
        assert chip_smoke.y4m_frame_sha1(str(y4m)) == want[name], name
    n = chip_smoke.FEATURE_BATCH_FRAMES
    batch = corpus.Group(size[0], size[1],
                         corpus.frame_pattern(clips[0].payloads[:n]), clips)
    engines = ["scalar"] + (["simd"] if bitwork.simd_supported() else [])
    for engine in engines:
        assert corpus.decode_batch(batch, "cpu", engine, frames=n,
                                   per_frame=True) == \
            [want[c.name][:n] for c in clips], engine


def jax_offgrid_digests():
    """chip_smoke.OFFGRID_ENCODE_SHA1 from the JAX package, as the comment
    above it describes."""
    from test_torch_fast_inter import jax_fast_path
    from test_torch_fast_patch import jax_patch_path
    cs = chip_smoke
    digest, frames = hashlib.sha1(), []
    for raster in JFilePlayer(str(cs.OFFGRID_CLIP)):
        digest.update(raster.dump_bytes())
        frames.append(tuple(np.array(p) for p in raster.display()))
    with open(FIXTURES / "natural_manifest.json") as fh:
        assert digest.hexdigest() == json.load(fh)[
            pathlib.Path(cs.OFFGRID_CLIP).name]["yuv_sha1"]
    w, h = frames[0][0].shape[1], frames[0][0].shape[0]
    got = {}
    for name, qi, two_pass in cs.KF_ENCODE_MODES:
        e = JEncoder(w, h, two_pass=two_pass, device_encode=False)
        for label, k in zip(cs.offgrid_labels("kf_" + name),
                            cs.OFFGRID_KF_FRAMES):
            got[label] = _sha(e.encode_with_quantizer(frames[k], qi,
                                                      key_frame=True))
    e = JEncoder(w, h, device_encode=False)
    got[cs.offgrid_labels("kf_min_ssim")[0]] = _sha(
        e.encode_with_minimum_ssim(frames[0], cs.KF_MIN_SSIM, key_frame=True))
    for name, qi, quality, two_pass in cs.INTER_ENCODE_MODES:
        e = JEncoder(w, h, quality=quality, two_pass=two_pass,
                     device_encode=False)
        for k, label in enumerate(cs.offgrid_labels("inter_" + name)):
            got[label] = _sha(e.encode_with_quantizer(frames[k], qi,
                                                      key_frame=k == 0))
    e = JEncoder(w, h, device_encode=False)
    for k, label in enumerate(cs.offgrid_labels("inter_min_ssim")):
        got[label] = _sha(e.encode_with_minimum_ssim(
            frames[k], cs.INTER_MIN_SSIM, key_frame=k == 0))
    e = JEncoder(w, h, quality="rt", device_encode=False)
    labels = cs.offgrid_labels("inter_pair")
    got[labels[0]] = _sha(e.encode_with_quantizer(
        frames[0], cs.INTER_PAIR_KEY_QI, key_frame=True))
    forks = [e.fork() for _ in cs.INTER_PAIR_QIS]
    for label, f, q in zip(labels[1:], forks, cs.INTER_PAIR_QIS):
        got[label] = _sha(f.encode_with_quantizer(frames[1], q))

    R, C = (h + 15) // 16, (w + 15) // 16
    for name, path in (("fast", jax_fast_path), ("patch_bpred",
                                                  jax_patch_path)):
        with path(R, C):
            labels = iter(cs.offgrid_labels(name))
            e = JEncoder(w, h, quality="rt", device_encode=False)
            got[next(labels)] = _sha(e.encode_with_quantizer(
                frames[0], cs.FAST_QI, key_frame=True))
            e.device_encode = True
            for k in range(1, cs.OFFGRID_FRAMES):
                got[next(labels)] = _sha(e.encode_with_quantizer(frames[k],
                                                                 cs.FAST_QI))
            labels = iter(cs.offgrid_labels(name + "_pair"))
            e = JEncoder(w, h, quality="rt", device_encode=False)
            got[next(labels)] = _sha(e.encode_with_quantizer(
                frames[0], cs.FAST_PAIR_KEY_QI, key_frame=True))
            e.device_encode = True
            for k in range(1, cs.OFFGRID_PAIR_FRAMES + 1):
                forks = [e.fork() for _ in cs.FAST_PAIR_QIS]
                for payload, _ in JEIF.encode_interframe_fast_multiqp(
                        forks, frames[k], [JQuantIndices(y_ac_qi=q)
                                           for q in cs.FAST_PAIR_QIS],
                        interpret=True):
                    got[next(labels)] = _sha(payload)
                e = forks[0]

    n0, qi = cs.OFFGRID_CHUNK, cs.REBASE_QI
    enc0 = JEncoder(w, h, device_encode=False)
    chunk0 = [enc0.encode_with_quantizer(f, qi) for f in frames[:n0]]
    encp = JEncoder(w, h, device_encode=False)
    pred_payloads = [encp.encode_with_quantizer(f, qi)
                     for f in frames[n0:cs.OFFGRID_FRAMES]]
    pstate = JDecoderState.initial(w, h)
    pred = []
    for p in pred_payloads:
        chunk = JUncompressedChunk(p, w, h)
        header, arrays, _ = JFrameParser(pstate).parse(chunk)
        pred.append((chunk.key_frame, header, arrays))
    reb = JEncoder(w, h, device_encode=False)
    reb.state, reb.references = enc0.state, enc0.references
    rebased = []

    class Sink:
        def append_frame(self, payload):
            rebased.append(payload)

    JRB.reencode(reb, frames[n0:cs.OFFGRID_FRAMES], pred,
                 cs.REBASE_KF_WEIGHT, False, Sink())
    got.update(zip(cs.offgrid_labels("rebase"),
                   map(_sha, chunk0 + pred_payloads + rebased)))
    return got


@pytest.mark.slow
def test_chip_smoke_offgrid_digests_from_jax():
    """chip_smoke.OFFGRID_ENCODE_SHA1, recomputed with the JAX package
    (minutes of CPU)."""
    assert jax_offgrid_digests() == chip_smoke.OFFGRID_ENCODE_SHA1


@pytest.mark.slow
def test_corrupted_stream_table_matches_jax():
    """tools/corrupted_streams.json, the port's CPU decode of the 64
    corrupted streams, against the JAX package's concealing Decoder on its
    numpy backend: each frame's raster SHA-1 or exception class, and each
    stream's SHA-1."""
    table = sanitize_fuzz.load_table()
    path = FIXTURES / sanitize_fuzz.CORRUPT_CLIP
    ivf = IVFReader(str(path))
    streams = sanitize_fuzz.corrupted_streams(str(path))
    assert len(streams) == len(table) == 64
    frames = 0
    for name, payloads in streams:
        dec = JDecoder(ivf.width, ivf.height, backend="numpy",
                       error_concealment=True)
        got = []
        for p in payloads:
            try:
                _, raster = dec.decode_frame(p)
                got.append(_sha(raster.dump_bytes()))
            except Exception as e:      # as sanitize_fuzz.decode_outcomes
                got.append("raise:" + type(e).__name__)
        assert table[name] == {"stream_sha1": sanitize_fuzz.stream_sha1(
            payloads), "frames": got}, name
        frames += len(got)
    assert frames == 768
