"""``intra_frame``: intra prediction of G frames, as the hand-written CUDA
kernel ``intra_row_kernel`` of csrc/wavefront.cu (entry
``intra_frame_launch``): one launch per call, persistent, a block per
(row, frame) that copies its row's inter macroblocks, then reconstructs
its intra macroblocks in order with K1's step, each after the same frame's
row above has published ``ROW_LAG`` macroblocks beyond its column
(csrc/row_sched.cuh).  No loop filter.

Replaces the TPU kernel alfalfa_tpu/ops/intra_pallas.py:intra_frame; the
source note in the .cu file says what was kept, what bounds it and what
the design does about it.  Its plain version is
ops.wavefront.intra_frame_plain: ``intra_frame`` takes it for CPU tensors
only.  A CUDA tensor launches the kernel or raises.
"""
import ctypes
import functools

import torch

from alfalfa_tpu_torch._build import (c_entry, check_aligned, launch,
                                     resident_blocks)
from alfalfa_tpu_torch.ops.wavefront import intra_frame_plain
from alfalfa_tpu_torch.ops.wavefront_cuda import (check_wave_inputs,
                                                  empty_planes,
                                                  pack_mb_params)

launches = 0        # op launches so far (not plain-version calls)
kernel_launches = 0  # ``<<<>>>`` launches the C entry reported issuing

# Macroblock (r, c) waits until row r - 1 has published min(c + ROW_LAG, C)
# macroblocks: its prediction reads the pixels of (r-1, c+1) (d = 2r + c).
ROW_LAG = 2

# the C entry's arguments before the stream: planes out, tiles, residuals,
# words, bmode; G, R, C; the schedule
ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 3
            + [ctypes.c_void_p, ctypes.c_int])


@functools.cache
def _entry():
    return c_entry("wavefront", "intra_frame_launch", ARGTYPES)


def resident(device):
    """Blocks of the kernel the card ``device`` holds at once."""
    return resident_blocks("wavefront", "intra_frame_resident", device)


def intra_frame(y, u, v, res_y, res_u, res_v, ymode, uvmode, bmode,
                has_nonzero, intra_mask):
    """Reconstruct G frames from their stage-B tiles, before the loop
    filter.

    Arguments as ops.wavefront_cuda.wavefront_decode's without lf_params:
    (G, R, C, S, S) uint8 tiles and int16 residuals, (G, R, C) maps,
    (G, R, C, 16) uint8 bmode.  Returns the unfiltered (G, 16R, 16C),
    (G, 8R, 8C), (G, 8R, 8C) uint8 planes: inter macroblocks as their
    tiles, intra macroblocks predicted from their unfiltered
    neighbours."""
    if y.device.type != "cuda":
        return intra_frame_plain(y, u, v, res_y, res_u, res_v, ymode, uvmode,
                                 bmode, has_nonzero, intra_mask)
    global launches, kernel_launches
    G, R, C = ymode.shape
    dev = y.device
    check_wave_inputs(dev, G, R, C, y, u, v, res_y, res_u, res_v, bmode,
                      {"ymode": ymode, "uvmode": uvmode,
                       "has_nonzero": has_nonzero, "intra_mask": intra_mask})
    # tile rows are copied in 8- and 16-byte words, residual rows with
    # 16-byte asynchronous copies
    check_aligned(y=(y, 16), u=(u, 8), v=(v, 8), res_y=(res_y, 16),
                  res_u=(res_u, 16), res_v=(res_v, 16))
    mbp = pack_mb_params(ymode, uvmode, has_nonzero, intra_mask)
    Y, U, V = empty_planes(G, R, C, dev)
    # the ticket, then each (frame, row)'s progress (zeroed: one memset)
    sched = torch.zeros(1 + G * R, dtype=torch.int32, device=dev)
    issued = launch(_entry(), "intra_frame", dev,
                    *(t.data_ptr() for t in (Y, U, V, y, u, v, res_y, res_u,
                                             res_v, mbp, bmode)),
                    G, R, C, sched.data_ptr(), ROW_LAG)
    launches += 1
    kernel_launches += issued
    return Y, U, V
