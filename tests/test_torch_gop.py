"""The slice as a whole: the port's BatchedGopDecoder against the JAX
package's, on the CPU, plane for plane (tolerance 0), plus the host parse
key by key, the manifest SHA-1 gate, and codec state carried across the
two packages in both directions.

The JAX side is the expensive one (each of its step functions compiles for
half a minute), so what needs the JAX decoder on the interframe clip sits
in one test: under pytest-xdist the tests of a file are spread over worker
processes, and a shared fixture would be computed once in each.
"""
import hashlib
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)    # many tiny ops: threads only add contention
import jax.numpy as jnp

from alfalfa_tpu.parallel import gop as JG
from alfalfa_tpu.state import decoder_state as JDS
from alfalfa_tpu.util.ivf import IVFReader

from alfalfa_tpu_torch import convert
from alfalfa_tpu_torch.parallel import gop as TG
from alfalfa_tpu_torch.state.decoder_state import Raster
from alfalfa_tpu_torch.util import tracing

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
G = 3
SPLIT = 2           # frames decoded before state is carried across


def _payloads(clip):
    ivf = IVFReader(str(FIXTURES / clip))
    return ivf.width, ivf.height, [ivf.frame(i) for i in range(len(ivf))]


def _np_planes(planes):
    return tuple(np.asarray(p) for p in planes)


def _snapshot_jax(dec):
    """States and references of a JAX decoder as plain numpy."""
    return ([convert.decoder_state_to_dict(s) for s in dec.states],
            {p: tuple(np.asarray(x) for x in dec.refs[p]) for p in "yuv"})


def _snapshot_port(dec):
    return ([convert.decoder_state_to_dict(s) for s in dec.states],
            {p: convert.refs_to_numpy(dec.refs[p]) for p in "yuv"})


def _jax_decode(clip, snapshot_at=None):
    w, h, payloads = _payloads(clip)
    dec = JG.BatchedGopDecoder(w, h, G)
    frames, snap = [], None
    for f, p in enumerate(payloads):
        if f == snapshot_at:
            snap = _snapshot_jax(dec)
        planes, show = dec.decode_frame_batch([p] * G)
        frames.append((_np_planes(planes), list(show)))
    return frames, snap


def _port_decode(clip, n_gops=G, stop_at=None):
    """decode_stream over the clip (or its first stop_at frames); returns
    the frames and the decoder as it stands afterwards."""
    w, h, payloads = _payloads(clip)
    dec = TG.BatchedGopDecoder(w, h, n_gops, device="cpu")
    frames = [(tuple(p.numpy() for p in planes), list(show))
              for planes, show in dec.decode_stream(
                  [p] * n_gops for p in payloads[:stop_at])]
    return frames, dec


CARRY = "inter_176x144_q96.ivf"
KEY = "kf_176x144_q16.ivf"


def _sha1s(w, h, frames):
    n = len(frames[0][1])
    digests = [hashlib.sha1() for _ in range(n)]
    for (y, u, v), show in frames:
        for g in range(n):
            if show[g]:
                digests[g].update(Raster(w, h, y[g], u[g], v[g]).dump_bytes())
    return [d.hexdigest() for d in digests]


def _manifest(clip):
    with open(FIXTURES / "manifest.json") as fh:
        return json.load(fh)[clip]["yuv_sha1"]


# ---------------------- (e) the slice as a whole, (f) state carried across

def _assert_frames_equal(got, want, what):
    assert len(got) == len(want), what
    for f, ((gp, gshow), (wp, wshow)) in enumerate(zip(got, want)):
        assert gshow == wshow, f"{what} frame {f}"
        for plane, a, b in zip("yuv", gp, wp):
            assert a.dtype == np.uint8
            np.testing.assert_array_equal(a, b, f"{what} frame {f} {plane}")


def test_decode_stream_equals_jax_on_key_frame_clip():
    """(e) port decode_stream == JAX decode_frame_batch, plane for plane,
    on the key-frame clip (B_PRED-heavy) at G=3."""
    _assert_frames_equal(_port_decode(KEY)[0], _jax_decode(KEY)[0], KEY)


def test_decode_stream_equals_jax_and_state_carries_across():
    """Everything that needs the JAX decoder on the interframe clip, in
    one test so its step functions compile once:

    (e) port decode_stream == JAX decode_frame_batch, plane for plane, at
        G=3;
    (f) JAX decodes SPLIT frames, state and references are converted, the
        port decodes the rest: equal to the all-JAX result; and the other
        way round, the port's state after SPLIT frames continues in JAX."""
    want, (states, refs) = _jax_decode(CARRY, snapshot_at=SPLIT)
    _assert_frames_equal(_port_decode(CARRY)[0], want, CARRY)

    w, h, payloads = _payloads(CARRY)
    dec = TG.BatchedGopDecoder(w, h, G, device="cpu")
    dec.states = [convert.decoder_state_from_dict(d) for d in states]
    dec.refs = {p: convert.refs_from_numpy(*refs[p], device="cpu")
                for p in "yuv"}
    assert dec.refs["y"].shape == (G, 3, dec.mb_rows * 16, dec.mb_cols * 16)
    rest = [(tuple(p.numpy() for p in planes), list(show))
            for planes, show in dec.decode_stream(
                [p] * G for p in payloads[SPLIT:])]
    _assert_frames_equal(rest, want[SPLIT:], "JAX state carried into the port")

    states, refs = _snapshot_port(_port_decode(CARRY, stop_at=SPLIT)[1])
    jdec = JG.BatchedGopDecoder(w, h, G)
    jdec.states = [convert.decoder_state_from_dict(d, classes=JDS)
                   for d in states]
    jdec.refs = {p: tuple(jnp.asarray(x) for x in refs[p]) for p in "yuv"}
    cont = []
    for f in range(SPLIT, SPLIT + 3):
        planes, show = jdec.decode_frame_batch([payloads[f]] * G)
        cont.append((_np_planes(planes), list(show)))
    _assert_frames_equal(cont, want[SPLIT:SPLIT + 3],
                         "port state carried into JAX")


@pytest.mark.parametrize("clip,n_gops", [(KEY, 2), (CARRY, 2),
                                         ("inter_320x240_q40.ivf", 1)])
def test_port_matches_manifest_sha1(clip, n_gops):
    """The port alone (no JAX run) against the golden SHA-1."""
    w, h, _ = _payloads(clip)
    got = _port_decode(clip, n_gops)[0]
    assert _sha1s(w, h, got) == [_manifest(clip)] * n_gops


@pytest.mark.slow
def test_port_matches_manifest_sha1_720p():
    clip = "inter_1280x720_q48.ivf"
    w, h, payloads = _payloads(clip)
    dec = TG.BatchedGopDecoder(w, h, 1, device="cpu")
    d = hashlib.sha1()
    for (y, u, v), show in dec.decode_stream([p] for p in payloads):
        if show[0]:
            d.update(Raster(w, h, y[0].numpy(), u[0].numpy(),
                            v[0].numpy()).dump_bytes())
    assert d.hexdigest() == _manifest(clip)


def test_decode_gops_entry_point():
    w, h, payloads = _payloads("kf_64x48_q40.ivf")
    out = TG.decode_gops([payloads, payloads], w, h, device="cpu")
    assert len(out) == 2 and len(out[0]) == len(payloads)
    y, u, v = out[1][0]
    d = hashlib.sha1(Raster(w, h, y.numpy(), u.numpy(), v.numpy())
                     .dump_bytes()).hexdigest()
    assert d == _manifest("kf_64x48_q40.ivf")
    with pytest.raises(ValueError):
        TG.decode_gops([payloads, payloads + payloads], w, h, device="cpu")


# --------------------------------------------------------- (d) host parse

def _parse_all(mod, clip, **kw):
    """Every frame's parse_frame_batch output, without the device step."""
    w, h, payloads = _payloads(clip)
    dec = mod.BatchedGopDecoder(w, h, G, **kw)
    out = []
    for p in payloads:
        key_frame, batch, _flags, show = dec.parse_frame_batch([p] * G)
        out.append((key_frame, {k: np.array(v) for k, v in batch.items()
                                if v is not None}, list(show)))
    return out, dec


@pytest.fixture(scope="module")
def jax_parse_320():
    return _parse_all(JG, "inter_320x240_q40.ivf")


def test_parse_frame_batch_key_by_key(jax_parse_320):
    want, _jdec = jax_parse_320
    got, _dec = _parse_all(TG, "inter_320x240_q40.ivf", device="cpu")
    assert len(got) == len(want)
    for f, ((gkf, gb, gshow), (wkf, wb, wshow)) in enumerate(zip(got, want)):
        assert gkf == wkf and gshow == wshow
        wb = {k: v for k, v in wb.items() if k != "intra_active"}
        assert set(gb) == set(wb), f
        for k in wb:
            assert gb[k].dtype == wb[k].dtype and gb[k].shape == wb[k].shape, k
            np.testing.assert_array_equal(gb[k], wb[k], f"frame {f} {k}")


def test_scatter_coeffs_on_fixture(jax_parse_320):
    want, jdec = jax_parse_320
    R, C = jdec.mb_rows, jdec.mb_cols
    for f in (0, 1):
        b = want[f][1]
        args = [b[k] for k in TG._COEFF_KEYS]
        w = np.asarray(JG._scatter_coeffs(
            G, R, C, *(jnp.asarray(a) for a in args)))
        g = TG._scatter_coeffs(G, R, C, *(torch.from_numpy(a) for a in args))
        assert g.dtype == torch.int16
        np.testing.assert_array_equal(g.numpy(), w)
        assert np.count_nonzero(w) > 1000


def test_header_state_after_stream_equals_jax(jax_parse_320):
    """The per-GOP header state (probabilities, segmentation, filter
    adjustments) advances identically in both packages."""
    _want, jdec = jax_parse_320
    _got, dec = _parse_all(TG, "inter_320x240_q40.ivf", device="cpu")
    for sj, st in zip(jdec.states, dec.states):
        dj = convert.decoder_state_to_dict(sj)
        dt = convert.decoder_state_to_dict(st)
        assert convert.decoder_state_from_dict(dj) == st
        assert convert.decoder_state_from_dict(dt, classes=JDS) == sj
        assert sj.hash() == st.hash()


@pytest.mark.parametrize("entry", ["parse_mb_headers_gop",
                                   "parse_tokens_gop_async"])
def test_missing_native_parser_falls_back_on_cpu_only(monkeypatch, entry):
    """Without the native library the Python parsers stand in for a CPU
    decoder (same output); a decoder on the card passes the load error on
    rather than time the slow parser as the host cost."""
    w, h, payloads = _payloads("kf_64x48_q40.ivf")
    want = TG.BatchedGopDecoder(w, h, 2, device="cpu") \
        .parse_frame_batch([payloads[0]] * 2)[1]

    def unavailable(*a, **kw):
        raise OSError("no native library")
    monkeypatch.setattr(TG.bitwork, entry, unavailable)
    got = TG.BatchedGopDecoder(w, h, 2, device="cpu") \
        .parse_frame_batch([payloads[0]] * 2)[1]
    assert set(got) == set(want)
    for k in want:
        if want[k] is not None:
            np.testing.assert_array_equal(got[k], want[k], k)
    dec = TG.BatchedGopDecoder(w, h, 2, device="cpu")
    dec.device = torch.device("cuda")       # parse touches no tensor
    with pytest.raises(OSError):
        dec.parse_frame_batch([payloads[0]] * 2)


def test_refs_roundtrip_through_numpy():
    rng = np.random.default_rng(3)
    planes = [rng.integers(0, 256, (G, 32, 48)).astype(np.uint8)
              for _ in range(3)]
    stack = convert.refs_from_numpy(*planes, device="cpu")
    assert stack.shape == (G, 3, 32, 48) and stack.dtype == torch.uint8
    for a, b in zip(convert.refs_to_numpy(stack), planes):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- tracing

def test_tracing_stages_cover_the_step():
    w, h, payloads = _payloads("kf_64x48_q40.ivf")
    tracing.snapshot()
    tracing.enable(True)
    try:
        dec = TG.BatchedGopDecoder(w, h, 2, device="cpu")
        list(dec.decode_stream([p] * 2 for p in payloads))
    finally:
        tracing.enable(False)
    snap = tracing.snapshot()
    for k in ("gop.parse", "gop.upload", "gop.device", "parse.tok_join"):
        assert snap[k]["count"] == len(payloads) and snap[k]["seconds"] > 0
    assert tracing.snapshot() == {}
