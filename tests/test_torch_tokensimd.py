"""The port's AVX-512 token engine (native/tokensimd.cc, taken by
``BatchedGopDecoder(token_engine="simd")``) on the CPU: the compact
coefficient stream and every other array of ``parse_frame_batch`` are held
byte for byte (tolerance 0) to the port's scalar parser and to the JAX
package's (scalar on hosts of more than 2 cores), key frames and
interframes.
G > 8 runs two or more 8-lane engines: interleaved in one loop on one
thread, or one engine a thread; the threaded cases G=12 / 2 threads and
G=32 / 4 threads are the ones the JAX package's copy of the engine faults
on (its workers reach a thread-local workspace of their own).  The engine
tests skip on a host without AVX-512, as the JAX package's do.
"""
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from alfalfa_tpu.parallel.gop import BatchedGopDecoder as JBatchedGopDecoder  # noqa: E402

from alfalfa_tpu_torch.native import bitwork  # noqa: E402
from alfalfa_tpu_torch.parallel.gop import BatchedGopDecoder  # noqa: E402
from alfalfa_tpu_torch.util.ivf import IVFReader  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
needs_avx512 = pytest.mark.skipif(not bitwork.simd_supported(),
                                  reason="no AVX-512 on this host")


def _batches(path, G, engine=None):
    """parse_frame_batch's arrays for every frame of ``path``, the frame
    repeated over G GOPs: the port's decoder under ``engine``, or the JAX
    package's (None)."""
    ivf = IVFReader(os.path.join(FIXTURES, path))
    if engine is None:
        dec = JBatchedGopDecoder(ivf.width, ivf.height, G)
    else:
        dec = BatchedGopDecoder(ivf.width, ivf.height, G, device="cpu",
                                token_engine=engine)
    out = []
    for i in range(len(ivf)):
        _, batch, _, _ = dec.parse_frame_batch([ivf.frame(i)] * G)
        out.append({k: np.asarray(v) for k, v in batch.items()
                    if v is not None and k != "intra_active"})
    return out


def _equal(got, want, what):
    assert len(got) == len(want)
    for f, (a, b) in enumerate(zip(got, want)):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, (what, f, k)
            np.testing.assert_array_equal(a[k], b[k], "%s frame %d: %s"
                                          % (what, f, k))


@needs_avx512
@pytest.mark.parametrize("path", [
    "kf_64x48_q40.ivf",         # key frame, B_PRED (no Y2 macroblocks)
    "kf_176x144_q16.ivf",       # dense key frame
    "inter_176x144_q96.ivf",    # interframes, skips
    "inter_320x240_q40.ivf",    # bigger interframes, value escapes
])
def test_simd_tokens_equal_scalar_and_jax(path):
    """G=3: the engine's stream equals the port's scalar parser's and the
    JAX package's; every frame went through the engine."""
    before = bitwork.engine_calls["simd"]
    got = _batches(path, 3, "simd")
    assert bitwork.engine_calls["simd"] - before == len(got)
    _equal(got, _batches(path, 3, "scalar"), "scalar")
    _equal(got, _batches(path, 3), "jax")


@needs_avx512
def test_simd_tokens_wide_batches(monkeypatch):
    """G > 8 on one thread (both engines interleaved in one loop: 8+4,
    8+8, a pair and a single, two pairs) and over threads (G=12 on 2,
    G=32 on 4): equal to the scalar parser."""
    monkeypatch.setenv("ALFALFA_PARSE_THREADS", "1")
    for G in (12, 16, 20, 32):
        _equal(_batches("inter_320x240_q40.ivf", G, "simd"),
               _batches("inter_320x240_q40.ivf", G, "scalar"),
               "G=%d one thread" % G)
    for G, threads in ((12, 2), (32, 4)):
        monkeypatch.setenv("ALFALFA_PARSE_THREADS", str(threads))
        assert bitwork.parse_threads(G) == threads
        _equal(_batches("inter_176x144_q96.ivf", G, "simd"),
               _batches("inter_176x144_q96.ivf", G, "scalar"),
               "G=%d on %d threads" % (G, threads))


def test_token_engine_choice(monkeypatch):
    """A forced "simd" raises where the engine reports no AVX-512 (at the
    decoder's construction and at a parse), an unknown name raises, and
    "auto" is scalar on hosts with more than 2 cores.  Where the engine
    runs, "auto" takes it on 2 cores, and a batch it declines (its -1,
    for G > 32) goes to the scalar parser, counted there."""
    with pytest.raises(ValueError, match="token engine"):
        bitwork.token_engine("avx")
    monkeypatch.setattr(bitwork.os, "cpu_count", lambda: 8)
    assert bitwork.token_engine("auto") is None
    assert bitwork.token_engine("scalar") is None
    supported = bitwork.simd_supported()
    saved = bitwork._simdlib
    monkeypatch.setattr(bitwork, "_simdlib", False)
    with pytest.raises(RuntimeError, match="AVX-512"):
        BatchedGopDecoder(64, 48, 2, device="cpu", token_engine="simd")
    with pytest.raises(RuntimeError, match="AVX-512"):
        bitwork.parse_tokens_gop([[b""]], 3, 4, [np.zeros(1056, np.uint8)],
                                 np.zeros((1, 3, 4), np.uint8),
                                 np.zeros((1, 3, 4), np.uint8),
                                 np.zeros((1, 3, 4), np.uint8),
                                 engine="simd")
    if not supported:
        return
    monkeypatch.setattr(bitwork, "_simdlib", saved)
    monkeypatch.setattr(bitwork.os, "cpu_count", lambda: 2)
    assert bitwork.token_engine("auto") is bitwork._load_simd()
    calls = dict(bitwork.engine_calls)
    want = _batches("inter_176x144_q96.ivf", 4, "scalar")
    assert bitwork.engine_calls["scalar"] - calls["scalar"] == len(want)
    _equal(_batches("inter_176x144_q96.ivf", 4, "auto"), want, "auto")
    assert bitwork.engine_calls["simd"] - calls["simd"] == len(want)
    # the engine's -1 (inputs it does not take): the scalar parser
    monkeypatch.setattr(bitwork, "_simd_call", lambda *a: -1)
    _equal(_batches("inter_176x144_q96.ivf", 4, "simd"), want, "declined")
    assert bitwork.engine_calls["simd"] - calls["simd"] == len(want)
    assert bitwork.engine_calls["scalar"] - calls["scalar"] == 2 * len(want)
