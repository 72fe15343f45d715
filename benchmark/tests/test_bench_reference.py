"""The plain reference decoder against the reference codec's own decodes
(the SHA-1 of every fixture's decoded frames, tests/fixtures/manifest.json),
and its control against the reference."""
import hashlib
import json
import os
import struct

import numpy as np
import pytest

from benchmark import harness
from benchmark.reference.vp8.decoder import Decoder

FIXTURES = os.path.join(harness.ROOT, "tests", "fixtures")
CLIPS = ["kf_64x48_q40.ivf", "kf_176x144_q16.ivf", "inter_176x144_q96.ivf",
         "inter_176x144_q8.ivf", "inter_176x144_rt_q48.ivf",
         "twopass_176x144_q32.ivf", "ssim80_176x144.ivf", "inter_320x240_q40.ivf"]


def ivf(path):
    with open(path, "rb") as f:
        d = f.read()
    w, h = struct.unpack("<HH", d[12:16])
    off, frames = 32, []
    while off < len(d):
        size = struct.unpack("<I", d[off:off + 4])[0]
        frames.append(d[off + 12:off + 12 + size])
        off += 12 + size
    return w, h, frames


@pytest.mark.parametrize("clip", CLIPS)
def test_the_reference_decodes_every_fixture_bit_exactly(clip):
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        want = json.load(f)[clip]["yuv_sha1"]
    w, h, frames = ivf(os.path.join(FIXTURES, clip))
    dec, sha = Decoder(w, h), hashlib.sha1()
    for payload in frames:
        show, (y, u, v), _ = dec.decode_frame(payload)
        if show:
            cw, ch = (w + 1) // 2, (h + 1) // 2
            sha.update(y[:h, :w].tobytes() + u[:ch, :cw].tobytes() + v[:ch, :cw].tobytes())
    assert sha.hexdigest() == want


def test_the_control_decode_differs():
    w, h, frames = ivf(os.path.join(FIXTURES, "inter_176x144_q32.ivf"))
    exact, control = Decoder(w, h), Decoder(w, h, exact=False)
    for payload in frames[:2]:
        a, b = exact.decode_frame(payload)[1], control.decode_frame(payload)[1]
        assert any(not np.array_equal(x, y) for x, y in zip(a, b))


def test_the_reference_ssim_repeats_the_programs_to_the_last_bit():
    import torch
    from alfalfa_tpu_torch.util.ssim import ssim as program_ssim
    from benchmark.reference.ssim import ssim
    rng = np.random.default_rng(5)
    for h, w in ((48, 64), (144, 176), (37, 53)):
        a = rng.integers(0, 256, (h, w), dtype=np.uint8)
        b = np.clip(a.astype(int) + rng.integers(-9, 10, (h, w)), 0, 255).astype(np.uint8)
        want = float(program_ssim(torch.from_numpy(a), torch.from_numpy(b)))
        assert ssim(a, b) == want


def test_the_luma_filtered_at_other_levels():
    """The frame's own level among ``filter_levels`` gives the luma the
    plain decode gives; another level gives another."""
    w, h, frames = ivf(os.path.join(FIXTURES, "inter_176x144_q32.ivf"))
    plain, levels = Decoder(w, h), Decoder(w, h)
    for payload in frames[:3]:
        _, planes, header = plain.decode_frame(payload)
        L = header.loop_filter_level
        _, again, _, others = levels.decode_frame(
            payload, lambda hd: [hd.loop_filter_level, hd.loop_filter_level + 1])
        assert all(np.array_equal(x, y) for x, y in zip(planes, again))
        assert np.array_equal(others[L], planes[0])
        if L:
            assert not np.array_equal(others[L + 1], planes[0])
