"""The port's tracing (``alfalfa_tpu_torch/util/tracing.py``): spans with
parents and self time, counters, the profiler ranges of ``xc --profile``,
and the spans and counters of ExCamera's chunk encode (a 64x48 chunk of 6
frames encoded, terminated, decoded along and saved on the CPU) as a
wrapper of ``tracing.stage(name, sync=False)`` sees them: a wrapper
installed on the module attribute, as a tool that draws the codec's
stages on its own clock installs one, sees every span the codec opens, and
no span but the synchronised ones drains the device.
"""
import contextlib
import json
import threading
import time
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from alfalfa_tpu_torch.decoder.decoder import Decoder
from alfalfa_tpu_torch.encoder.encoder import Encoder
from alfalfa_tpu_torch.encoder.serializer import refresh_all_references
from alfalfa_tpu_torch.state import serdes
from alfalfa_tpu_torch.util import tracing


@pytest.fixture
def traced():
    """Tracing on, from an empty record, and off again after the test."""
    tracing.snapshot()
    tracing.enable(True)
    try:
        yield
    finally:
        tracing.enable(False)
        tracing.snapshot()


def test_nested_spans_self_seconds(traced):
    with tracing.stage("outer"):
        time.sleep(0.05)
        with tracing.stage("inner"):
            time.sleep(0.03)
        t0 = time.perf_counter()
        time.sleep(0.01)
        tracing.add("added", time.perf_counter() - t0)
    snap = tracing.snapshot()
    outer, inner, added = snap["outer"], snap["inner"], snap["added"]
    assert outer["count"] == inner["count"] == added["count"] == 1
    assert inner["seconds"] >= 0.03 and inner["self_seconds"] == inner["seconds"]
    assert outer["seconds"] >= 0.09
    # the outer span's own sleep: its children's time taken out
    assert outer["self_seconds"] == pytest.approx(
        outer["seconds"] - inner["seconds"] - added["seconds"], abs=1e-9)
    assert 0.05 <= outer["self_seconds"] < outer["seconds"] - 0.04
    assert "value" not in outer


def test_parents_kept_apart_on_two_threads(traced):
    """Two threads nest spans at once: each outer span loses only its own
    thread's child time."""
    gate = threading.Barrier(2, timeout=10)

    def work(tag, inner_s):
        with tracing.stage(tag + ".outer"):
            gate.wait()
            with tracing.stage(tag + ".inner"):
                time.sleep(inner_s)
            gate.wait()
            time.sleep(0.02)

    threads = [threading.Thread(target=work, args=(t, s))
               for t, s in (("a", 0.01), ("b", 0.06))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
        assert not t.is_alive()
    snap = tracing.snapshot()
    for tag in "ab":
        outer, inner = snap[tag + ".outer"], snap[tag + ".inner"]
        assert outer["self_seconds"] == pytest.approx(
            outer["seconds"] - inner["seconds"], abs=1e-9)
        assert outer["self_seconds"] >= 0.02
    # thread a waited for b's longer inner span, in its own outer span
    assert snap["a.outer"]["self_seconds"] >= 0.06


def test_counters(traced):
    tracing.count("work.bytes", 5)
    tracing.count("work.bytes", 7)
    tracing.count("work.calls")
    snap = tracing.snapshot()
    assert snap["work.bytes"] == {"seconds": 0.0, "self_seconds": 0.0,
                                  "count": 2, "value": 12}
    assert snap["work.calls"]["value"] == 1
    assert tracing.snapshot() == {}


def test_tracing_off_records_nothing():
    tracing.snapshot()
    assert not tracing.enabled()
    with tracing.stage("off.span", sync=True):
        tracing.count("off.counter", 3)
        tracing.add("off.add", 1.0)
    assert tracing.snapshot() == {}
    # a disabled span allocates nothing
    assert tracing.stage("a") is tracing.stage("b")


@pytest.mark.parametrize("enabled", [False, True])
def test_profiler_ranges_only_inside_profile(tmp_path, monkeypatch, enabled):
    """Every span opens a profiler range inside ``tracing.profile()``,
    whether tracing is enabled or not, and none outside it."""
    opened = []
    real = torch.profiler.record_function

    def spy(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    tracing.snapshot()
    tracing.enable(enabled)
    try:
        with tracing.stage("codec.before"):
            pass
        assert opened == []
        with tracing.profile(str(tmp_path)):
            with tracing.stage("codec.span"):
                torch.ones(64).sum()
        with tracing.stage("codec.after"):
            pass
    finally:
        tracing.enable(False)
    assert opened == ["codec.span"]
    spans = tracing.snapshot()
    assert set(spans) == ({"codec.before", "codec.span", "codec.after"}
                          if enabled else set())
    (trace,) = tmp_path.glob("*.trace.json")
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert "codec.span" in names and "codec.before" not in names


def _frames(W, H, F, seed=7):
    """A grainy texture panning two pixels a frame, flat chroma."""
    rng = np.random.default_rng(seed)
    tex = rng.integers(0, 256, (H + F, W + 2 * F)).astype(np.float64)
    tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, 1, 1)
           + np.roll(tex, (1, 1), (0, 1))) / 4
    c = np.full((H // 2, W // 2), 128, np.uint8)
    return [(np.clip(tex[i:i + H, 2 * i:2 * i + W]
                     + rng.normal(0, 2, (H, W)), 0, 255).astype(np.uint8),
             c, c) for i in range(F)]


# the spans the chunk encode opens, each once a frame, a chunk or a call
CHUNK_SPANS = {
    "enc.new": 1, "enc.frame": 6, "decode.new": 1, "decode.frame": 6,
    "enc.terminate": 1, "state.save": 1, "decode.parse": 6,
    "decode.reconstruct": 6, "decode.prep": 6, "decode.upload": 6,
    "decode.device": 6, "enc.kf_mb_wavefront": 1, "enc.fetch": 1,
    "enc.lf_search": 1, "enc.inter_kernel": 5, "enc.inter_host": 5,
    "enc.if_lf_search": 5}
D2H_SITES = ("d2h.enc_fetch", "d2h.inter_fetch", "d2h.ssim",
             "d2h.state_save")


def test_chunk_encode_spans_and_counters(monkeypatch):
    """ExCamera's chunk worker at 64x48: 6 frames encoded, the last
    terminated, the chunk decoded along and its exit state saved, under a
    wrapper of ``tracing.stage`` on the module attribute."""
    W, H, F = 64, 48, 6
    frames = _frames(W, H, F)
    opened = []
    orig = tracing.stage

    @contextlib.contextmanager
    def wrapper(name, sync=False):
        opened.append((name, sync))
        with orig(name, sync):
            yield

    drains = []
    monkeypatch.setattr(tracing, "stage", wrapper)
    monkeypatch.setattr(tracing, "_device_sync", lambda: drains.append(1))
    tracing.snapshot()
    tracing.enable(True)
    try:
        enc = Encoder(W, H, device="cpu")
        payloads = [enc.encode_with_quantizer(f, 48) for f in frames]
        dec = Decoder(W, H, device="cpu")
        for i, p in enumerate(payloads):
            if i == F - 1:
                p = refresh_all_references(p, dec.state.copy(), W, H,
                                           show=True)
            dec.decode_frame(p)
        serdes.save_decoder(dec.state, dec.references)
    finally:
        tracing.enable(False)
    snap = tracing.snapshot()
    seen = Counter(name for name, _ in opened)
    for name, n in CHUNK_SPANS.items():
        assert seen[name] == n == snap[name]["count"], name
    # the loop-filter search's children, once a search call each
    searches = snap["enc.lf_search"]["count"] + snap["enc.if_lf_search"]["count"]
    for name in ("enc.lf_params", "enc.lf_filter", "enc.lf_score",
                 "ssim.serial_mean"):
        assert seen[name] == snap[name]["count"] >= searches, name
    # every span the wrapper saw is in the record, and the other way round
    assert set(seen) == {k for k, v in snap.items() if "value" not in v}
    for name, v in snap.items():
        assert 0 <= v["self_seconds"] <= v["seconds"] + 1e-9, name
    filtered = snap["enc.lf_levels_filtered"]["value"]
    climbed = snap["enc.lf_levels_climbed"]["value"]
    assert snap["enc.lf_levels_climbed"]["count"] == F
    assert filtered >= climbed >= F
    for site in D2H_SITES:
        assert snap[site]["value"] > 0, site
    R, C = (H + 15) // 16, (W + 15) // 16
    assert snap["d2h.state_save"]["value"] == R * C * 384
    # only the synchronised spans drain the device, twice each
    assert len(drains) == 2 * sum(sync for _, sync in opened)
    assert {name for name, sync in opened if sync} == {
        "enc.kf_mb_wavefront", "enc.lf_search", "enc.inter_kernel",
        "enc.if_lf_search", "decode.reconstruct"}
