"""The single-frame slice as a whole: the port's ``Decoder`` (CPU, so the
kernel wrappers take their plain versions) against the JAX package's
``Decoder`` on its numpy backend (the backend ``resolve_backend`` picks
off-TPU, and the one the JAX package's own tests hold its jax backend to),
frame for frame, tolerance 0.  Plus the manifest SHA-1, state files and
whole decoders carried between the packages both ways, ``copy()`` as a
value, error concealment, the ``xc`` command line and the CUDA default.

The kernels' plain versions are held against the Pallas kernels by
tests/test_torch_kernels_plain.py; on the card ``chip_smoke.py`` holds the
CUDA kernels against them.
"""
import hashlib
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)    # many tiny ops: threads only add contention

from alfalfa_tpu.decoder.decoder import Decoder as JDecoder, \
    FilePlayer as JFilePlayer
from alfalfa_tpu.state import decoder_state as JDS, serdes as JSerdes
from alfalfa_tpu.util.ivf import IVFReader

from alfalfa_tpu_torch import convert
from alfalfa_tpu_torch.cli import xc
from alfalfa_tpu_torch.decoder import Decoder, FilePlayer
from alfalfa_tpu_torch.state import serdes
from alfalfa_tpu_torch.state.decoder_state import DecoderState, Raster, \
    References

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures"
CPU = torch.device("cpu")
CLIPS = sorted(p.name for p in FIXTURES.glob("*.ivf")
               if p.name != "inter_1280x720_q48.ivf")
CARRY = "inter_176x144_q96.ivf"


def _manifest(clip):
    with open(FIXTURES / "manifest.json") as fh:
        return json.load(fh)[clip]["yuv_sha1"]


def _payloads(clip):
    ivf = IVFReader(str(FIXTURES / clip))
    return ivf.width, ivf.height, [ivf.frame(i) for i in range(len(ivf))]


def _assert_same(port_raster, jax_raster, what):
    jax_raster.to_host()
    for plane, a, b in zip("yuv", port_raster.to_host(),
                           (jax_raster.y, jax_raster.u, jax_raster.v)):
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, b, "%s %s" % (what, plane))


def _assert_same_decoder(port, jax, what):
    assert port.get_hash() == jax.get_hash(), what
    assert port.minihash() == jax.minihash(), what


def _decode(dec, payloads, jdec=None, what=""):
    """Decode ``payloads`` with the port's decoder, and with the JAX
    package's in step if given: shown flags, planes and hashes equal
    after every frame."""
    for f, p in enumerate(payloads):
        shown, raster = dec.decode_frame(p)
        assert isinstance(raster.y, torch.Tensor) and raster.y.device == CPU
        if jdec is not None:
            jshown, jraster = jdec.decode_frame(p)
            assert shown == jshown, "%s frame %d" % (what, f)
            _assert_same(raster, jraster, "%s frame %d" % (what, f))
            _assert_same_decoder(dec, jdec, "%s frame %d" % (what, f))


@pytest.mark.parametrize("clip", CLIPS)
def test_file_player_equals_jax_decoder_and_manifest(clip):
    """Every fixture but the 720p clip, through both packages' FilePlayer in
    step: the same frames shown, equal planes, equal decoder hashes and
    minihashes after each one; and the port's output meets the manifest
    SHA-1 on its own."""
    path = str(FIXTURES / clip)
    port, jax_ = FilePlayer(path, device="cpu"), JFilePlayer(path)
    digest = hashlib.sha1()
    n = 0
    for raster, jraster in zip(port, jax_):
        assert port.frame_no == jax_.frame_no         # same frames shown
        _assert_same(raster, jraster, "%s frame %d" % (clip, port.frame_no))
        _assert_same_decoder(port.decoder, jax_.decoder, clip)
        digest.update(raster.dump_bytes())
        n += 1
    assert port.eof() and jax_.eof() and n > 0
    assert digest.hexdigest() == _manifest(clip)


def test_state_file_from_jax_continues_in_port():
    """A .state file written by the JAX package after k frames, loaded by
    the port, continues equal to the JAX package continuing from the same
    file; the port writes the same bytes back."""
    w, h, payloads = _payloads(CARRY)
    k = 8
    jdec = JDecoder(w, h)
    for p in payloads[:k]:
        jdec.decode_frame(p)
    data = JSerdes.save_decoder(jdec.state, jdec.references)
    state, refs = serdes.load_decoder(data, device="cpu")
    assert refs.last is refs.golden is refs.alternative
    assert isinstance(refs.last.y, torch.Tensor)
    assert serdes.save_decoder(state, refs) == data
    jstate, jrefs = JSerdes.load_decoder(data)
    port = Decoder(w, h, state=state, references=refs, device="cpu")
    jdec = JDecoder(w, h, state=jstate, references=jrefs)
    _assert_same_decoder(port, jdec, "loaded")
    _decode(port, payloads[k:], jdec, "JAX state file into the port")


def test_state_file_from_port_continues_in_jax(tmp_path):
    """The other way: the port's .state file after k frames is the JAX
    package's file byte for byte, and the JAX package continues from it
    as the port does."""
    w, h, payloads = _payloads(CARRY)
    k = 3
    port, jdec = Decoder(w, h, device="cpu"), JDecoder(w, h)
    for p in payloads[:k]:
        port.decode_frame(p)
        jdec.decode_frame(p)
    path = tmp_path / "port.state"
    data = serdes.save_decoder(port.state, port.references, str(path))
    assert path.read_bytes() == data
    assert data == JSerdes.save_decoder(jdec.state, jdec.references)
    jstate, jrefs = JSerdes.load_decoder(str(path))
    state, refs = serdes.load_decoder(str(path), device="cpu")
    port = Decoder(w, h, state=state, references=refs, device="cpu")
    jdec = JDecoder(w, h, state=jstate, references=jrefs)
    _decode(port, payloads[k:k + 4], jdec, "port state file into JAX")


def test_whole_decoder_carried_both_ways():
    """convert.decoder_to_dict / decoder_from_dict: a JAX decoder with
    three different references becomes a port decoder with the same hash
    that decodes on as the JAX one does, and back."""
    w, h, payloads = _payloads("inter_176x144_q32.ivf")
    jdec = JDecoder(w, h)
    for p in payloads[:5]:
        jdec.decode_frame(p)
    port = convert.decoder_from_dict(convert.decoder_to_dict(jdec),
                                     device="cpu")
    _assert_same_decoder(port, jdec, "JAX decoder into the port")
    _decode(port, payloads[5:7], jdec, "after the carry")
    back = convert.decoder_from_dict(convert.decoder_to_dict(port),
                                     decoder_cls=JDecoder, classes=JDS)
    assert isinstance(back, JDecoder)
    _assert_same_decoder(port, back, "port decoder into JAX")
    _decode(port, payloads[7:8], back, "after carrying back")
    d = convert.references_to_dict(References.create(w, h))
    assert len(d["rasters"]) == 1                    # one shared raster
    refs = convert.references_from_dict(d, device="cpu")
    assert refs.last is refs.golden is refs.alternative


def test_copy_is_a_value(monkeypatch):
    """A copy decodes on its own, sharing only its decoder's upload
    buffers.  Each frame's parse arrays go up in one packed copy
    (parallel/upload.py), and an interframe hands the six-tap kernel the
    reference rasters' own planes: no stacked copy of the references."""
    from alfalfa_tpu_torch.decoder import reconstruct_torch as RT
    from alfalfa_tpu_torch.parallel import upload
    uploads, seen = [], []
    saved_upload, saved_mc = upload.PinnedStaging.upload, RT.predict_mb_tiles

    def counted(self, mega):
        uploads.append(mega.size)
        return saved_upload(self, mega)

    def recorded(refs, *a):
        seen.append(refs)
        return saved_mc(refs, *a)

    monkeypatch.setattr(upload.PinnedStaging, "upload", counted)
    monkeypatch.setattr(RT, "predict_mb_tiles", recorded)
    w, h, payloads = _payloads(CARRY)
    dec = Decoder(w, h, device="cpu")
    for f, p in enumerate(payloads[:2]):
        refs = dec.references
        want = [getattr(r, q) for q in "yuv" for r in
                (refs.last, refs.golden, refs.alternative)]
        _decode(dec, [p])
        assert len(uploads) == f + 1
    assert len(seen) == 1            # frame 1: the rasters themselves
    assert all(a is b for a, b in
               zip([t for q in "yuv" for t in seen[0][q]], want))
    before = dec.get_hash()
    other = dec.copy()
    assert other.get_hash() == before and other._staging is dec._staging
    _decode(other, payloads[2:4])
    assert dec.get_hash() == before and other.get_hash() != before
    _decode(dec, payloads[2:4])
    assert dec.get_hash() == other.get_hash()
    raster = dec.references.last
    clone = raster.copy()
    assert clone.y is not raster.y and clone == raster


def test_error_concealment_equals_jax():
    """A truncated interframe, concealed, and the frames after it."""
    w, h, payloads = _payloads("inter_176x144_q32.ivf")
    cut = payloads[1][:len(payloads[1]) // 2]
    port = Decoder(w, h, device="cpu", error_concealment=True)
    jdec = JDecoder(w, h, error_concealment=True)
    _decode(port, [payloads[0], cut, payloads[2]], jdec, "concealment")


def test_raster_keeps_device_planes_and_one_host_copy():
    rng = np.random.default_rng(2)
    planes = [torch.from_numpy(rng.integers(0, 256, s).astype(np.uint8))
              for s in ((48, 64), (24, 32), (24, 32))]
    r = Raster(60, 40, *planes)
    host = r.to_host()
    assert r.to_host() is host and r.y is planes[0]   # kept, not replaced
    assert r.display()[0].shape == (40, 60)
    assert r.hash() == Raster(60, 40, *host).hash()
    same = Raster(60, 40, *host).on_device("cpu")
    assert isinstance(same.y, torch.Tensor) and same == r
    assert same.on_device("cpu") is same


def test_decoder_defaults_to_cuda():
    """No device means CUDA: on a host without one that raises, it does
    not fall back to the CPU."""
    with pytest.raises((AssertionError, RuntimeError)):
        Decoder(64, 48)
    with pytest.raises((AssertionError, RuntimeError)):
        FilePlayer(str(FIXTURES / "kf_64x48_q40.ivf"))
    data = serdes.save_decoder(DecoderState(64, 48),
                               References.create(64, 48))
    with pytest.raises((AssertionError, RuntimeError)):
        serdes.load_decoder(data)


def test_xc_decode_raw_and_state(tmp_path, capsysbinary):
    """``python -m alfalfa_tpu_torch.cli.xc decode-raw`` in a subprocess
    prints the manifest's bytes; ``decode`` (y4m) and ``decode-raw`` with
    ``-s`` and a state file do too, through ``xc.main``."""
    clip = str(FIXTURES / "kf_64x48_q40.ivf")
    want = _manifest("kf_64x48_q40.ivf")
    out = subprocess.run(
        [sys.executable, "-m", "alfalfa_tpu_torch.cli.xc", "decode-raw",
         "--device", "cpu", clip],
        cwd=REPO, capture_output=True, check=True).stdout
    assert hashlib.sha1(out).hexdigest() == want
    w, h, payloads = _payloads("kf_64x48_q40.ivf")
    dec = Decoder(w, h, device="cpu")
    _decode(dec, payloads)
    state = tmp_path / "after.state"
    serdes.save_decoder(dec.state, dec.references, str(state))
    y4m = tmp_path / "out.y4m"
    xc.main(["decode", "-s", str(state), "--device", "cpu", clip, str(y4m)])
    frames = y4m.read_bytes().split(b"FRAME\n")[1:]
    assert hashlib.sha1(b"".join(frames)).hexdigest() == want
    capsysbinary.readouterr()
    xc.main(["decode-raw", "--state", str(state), "--device", "cpu", clip])
    assert hashlib.sha1(capsysbinary.readouterr().out).hexdigest() == want


@pytest.mark.slow
@pytest.mark.parametrize("name", ["360x242", "720p"])
def test_chip_smoke_decode_raw_digests_from_jax(name):
    """chip_smoke.XC_DECODE_RAW_SHA1: the JAX package's ``xc decode-raw``
    in a subprocess on the CPU (the 720p fixture about two minutes)."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    clip = {"720p": chip_smoke.CLIP, "360x242": chip_smoke.OFFGRID_CLIP}[name]
    raw = subprocess.run(
        [sys.executable, "-m", "alfalfa_tpu.cli.xc", "decode-raw", clip],
        capture_output=True, check=True, cwd=str(REPO),
        env=dict(os.environ, JAX_PLATFORMS="cpu")).stdout
    assert hashlib.sha1(raw).hexdigest() == \
        chip_smoke.XC_DECODE_RAW_SHA1[name]
