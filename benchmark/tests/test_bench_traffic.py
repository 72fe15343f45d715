"""The traffic generator: the same inputs for a seed, other inputs for
another, the same sizes for every seed."""
import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.traffic import natural


@pytest.mark.parametrize("cell", ["excamera-4k.decode-g16", "excamera-4k.chunk-encode"])
def test_a_seed_gives_the_same_frames_and_another_seed_others(cell):
    wl, _ = harness.cell(cell)
    params = dict(wl["traffic"]["content"])
    for o in params.get("objects", []):
        o.update(size=24, amplitude=[10, 20])
    clip = lambda seed: natural.clip(params, 96, 64, 7, seed, torch.device("cpu"))
    a, b, c = clip(2 ** 40 + 3), clip(2 ** 40 + 3), clip(12)
    assert len(a) == len(c) == 7
    for fa, fb, fc in zip(a, b, c):
        assert [p.shape for p in fa] == [(64, 96), (32, 48), (32, 48)]
        assert all(p.dtype == np.uint8 for p in fa)
        assert all(np.array_equal(x, y) for x, y in zip(fa, fb))
        assert not np.array_equal(fa[0], fc[0])
    # the camera moves: consecutive frames differ
    assert not np.array_equal(a[0][0], a[1][0])


def test_the_cut_lands_on_the_same_frame_for_every_seed():
    params = {"pan": [1.0, 2.0], "cut_at": [4], "grain": 0.0}
    for seed in (1, 2 ** 33):
        f = natural.clip(params, 64, 48, 6, seed, torch.device("cpu"))
        step = [np.abs(f[i + 1][0].astype(int) - f[i][0]).mean() for i in range(5)]
        assert int(np.argmax(step)) == 3
