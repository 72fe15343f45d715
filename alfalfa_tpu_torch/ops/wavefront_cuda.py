"""``wavefront_decode``: intra prediction and loop filter of G frames in
lockstep, as the hand-written CUDA kernel ``wave_row_kernel`` of
csrc/wavefront.cu (entry ``wavefront_decode_launch``): one launch per call,
persistent, a warp per (row, frame) walking its row, reconstructing and
then filtering each macroblock, and waiting for the same frame's row above
to publish ``ROW_LAG`` macroblocks beyond its column (csrc/row_sched.cuh).

Replaces the TPU kernel alfalfa_tpu/ops/wavefront_pm.py:
wavefront_frame_batch_pm; the source note in the .cu file says what was
kept, what bounds it and what the design does about it.  Its plain version
is ops.wavefront.wavefront_decode_plain: ``wavefront_decode`` takes it for
CPU tensors only.  A CUDA tensor launches the kernel or raises.
"""
import ctypes
import functools

import torch

from alfalfa_tpu_torch._build import (c_entry, check_aligned, check_map,
                                     check_tensor, launch, resident_blocks)
from alfalfa_tpu_torch.ops.wavefront import wavefront_decode_plain

launches = 0        # op launches so far (not plain-version calls)
kernel_launches = 0  # ``<<<>>>`` launches the C entry reported issuing

NP = 12             # int16 words per macroblock, see csrc/wavefront_device.cuh

# Macroblock (r, c) waits until row r - 1 has published min(c + ROW_LAG, C)
# macroblocks: its intra prediction reads the unfiltered pixels of
# (r-1, c+1), and its top edge the pixels of (r-1, c) that (r-1, c+1)'s
# left edge writes (d = 2r + c).
ROW_LAG = 2

# wavefront_decode_launch's: planes out, the unfiltered bottom rows, tiles,
# residuals, words, bmode; G, R, C; the schedule
ARGTYPES = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 3
            + [ctypes.c_void_p, ctypes.c_int])


@functools.cache
def _entry():
    return c_entry("wavefront", "wavefront_decode_launch", ARGTYPES)


def resident(device):
    """Blocks (warps) of the kernel the card ``device`` holds at once."""
    return resident_blocks("wavefront", "wavefront_decode_resident", device)


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
    # the kernel reads tile and residual rows and the b-modes in 8- and
    # 16-byte words
    check_aligned(y=(y, 16), u=(u, 8), v=(v, 8), res_y=(res_y, 16),
                  res_u=(res_u, 16), res_v=(res_v, 16), bmode=(bmode, 16))
    mbp = pack_mb_params(ymode, uvmode, has_nonzero, intra_mask, lf_params)
    Y, U, V = empty_planes(G, R, C, dev)
    # every macroblock's unfiltered bottom pixel row, written and read
    # during the launch: the row below predicts from them
    ey = torch.empty((G, R, C * 16), dtype=torch.uint8, device=dev)
    eu, ev = (torch.empty((G, R, C * 8), dtype=torch.uint8, device=dev)
              for _ in range(2))
    # the ticket, then each (frame, row)'s progress (zeroed: one memset)
    sched = torch.zeros(1 + G * R, dtype=torch.int32, device=dev)
    issued = launch(_entry(), "wavefront_decode", dev,
                    *(t.data_ptr() for t in (Y, U, V, ey, eu, ev, y, u, v,
                                             res_y, res_u, res_v, mbp,
                                             bmode)),
                    G, R, C, sched.data_ptr(), ROW_LAG)
    launches += 1
    kernel_launches += issued
    return Y, U, V
