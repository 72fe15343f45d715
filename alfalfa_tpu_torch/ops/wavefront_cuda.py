"""``wavefront_decode``: intra prediction and loop filter of G frames in
lockstep, as the hand-written CUDA kernels of csrc/wavefront.cu.

Replaces the TPU kernel alfalfa_tpu/ops/wavefront_pm.py:
wavefront_frame_batch_pm; the source note in the .cu file says what was
kept, what bounds it and what the design does about it.  Its plain version
is ops.wavefront.wavefront_decode_plain: ``wavefront_decode`` takes it for
CPU tensors only.  A CUDA tensor launches the kernels or raises.

One call enqueues its kernel launches from C (one per diagonal and phase,
plus one) and counts as one launch of the op; ``kernel_launches`` sums the
number the C entry reports having issued.
"""
import ctypes
import functools

import torch

from alfalfa_tpu_torch._build import c_entry, check_map, check_tensor, launch
from alfalfa_tpu_torch.ops.wavefront import wavefront_decode_plain

launches = 0        # op launches so far (not plain-version calls)
kernel_launches = 0  # ``<<<>>>`` launches the C entry reported issuing

NP = 12             # int16 words per macroblock, see csrc/wavefront_device.cuh

# the argument types shared by wavefront_decode_launch and intra_frame_launch:
# planes out, tiles, residuals, words, bmode; G, R, C
WAVE_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3


@functools.cache
def _entry():
    return c_entry("wavefront", "wavefront_decode_launch", WAVE_ARGTYPES)


def pack_mb_params(ymode=None, uvmode=None, has_nonzero=None, intra_mask=None,
                   lf_params=None):
    """The per-macroblock parameter words the kernels read:
    (G, R, C, NP) int16.  The words of an argument left out are 0: the
    intra kernels read words 0-3, the loop filter words 4-9."""
    lf = tuple(lf_params) if lf_params is not None else (None,) * 6
    given = (ymode, uvmode, has_nonzero, intra_mask) + lf
    like = next(x for x in given if x is not None)
    z = torch.zeros(like.shape, dtype=torch.int16, device=like.device)
    words = [z if x is None else x.to(torch.int16) for x in given]
    return torch.stack(words + [z, z], dim=-1).contiguous()


def check_wave_inputs(dev, G, R, C, y, u, v, res_y, res_u, res_v, bmode,
                      maps):
    """Raise unless the tiles, residuals, bmode and the (G, R, C) maps
    ``maps`` ({name: tensor}) are what the wavefront kernels take."""
    for name, t, dt, S in (("y", y, torch.uint8, 16), ("u", u, torch.uint8, 8),
                           ("v", v, torch.uint8, 8),
                           ("res_y", res_y, torch.int16, 16),
                           ("res_u", res_u, torch.int16, 8),
                           ("res_v", res_v, torch.int16, 8)):
        check_tensor(name, t, dt, (G, R, C, S, S), dev)
    check_tensor("bmode", bmode, torch.uint8, (G, R, C, 16), dev)
    for name, t in maps.items():
        check_map(name, t, (G, R, C), dev)


def empty_planes(G, R, C, dev):
    """Uninitialised (G, 16R, 16C), (G, 8R, 8C), (G, 8R, 8C) uint8 planes."""
    return (torch.empty((G, R * 16, C * 16), dtype=torch.uint8, device=dev),
            torch.empty((G, R * 8, C * 8), dtype=torch.uint8, device=dev),
            torch.empty((G, R * 8, C * 8), dtype=torch.uint8, device=dev))


def wavefront_decode(y, u, v, res_y, res_u, res_v, ymode, uvmode, bmode,
                     has_nonzero, intra_mask, lf_params):
    """Finish G frames after the dense stages.

    y: (G, R, C, 16, 16), u, v: (G, R, C, 8, 8) uint8 stage-B tiles (inter
    macroblocks final before filtering, intra macroblocks don't-care);
    res_y/res_u/res_v: int16 residual tiles of the same shapes (B_PRED
    reads its 4x4 blocks out of the assembled res_y, so no second,
    sub-block layout is passed); ymode, uvmode: (G, R, C) int; bmode:
    (G, R, C, 16) uint8; has_nonzero, intra_mask: (G, R, C) bool;
    lf_params: (level, interior, mb_limit, sb_limit, hev, skip_sb), each
    (G, R, C) (level 0 = macroblock not filtered).

    Returns decoded, loop-filtered (G, 16R, 16C), (G, 8R, 8C), (G, 8R, 8C)
    uint8 planes."""
    if y.device.type != "cuda":
        return wavefront_decode_plain(y, u, v, res_y, res_u, res_v, ymode,
                                      uvmode, bmode, has_nonzero, intra_mask,
                                      lf_params)
    global launches, kernel_launches
    G, R, C = ymode.shape
    dev = y.device
    maps = {"ymode": ymode, "uvmode": uvmode, "has_nonzero": has_nonzero,
            "intra_mask": intra_mask}
    maps.update(("lf_params[%d]" % i, t) for i, t in enumerate(lf_params))
    check_wave_inputs(dev, G, R, C, y, u, v, res_y, res_u, res_v, bmode, maps)
    mbp = pack_mb_params(ymode, uvmode, has_nonzero, intra_mask, lf_params)
    Y, U, V = empty_planes(G, R, C, dev)
    issued = launch(_entry(), "wavefront_decode", dev,
                    Y.data_ptr(), U.data_ptr(), V.data_ptr(),
                    y.data_ptr(), u.data_ptr(), v.data_ptr(),
                    res_y.data_ptr(), res_u.data_ptr(), res_v.data_ptr(),
                    mbp.data_ptr(), bmode.data_ptr(), G, R, C)
    launches += 1
    kernel_launches += issued
    return Y, U, V
