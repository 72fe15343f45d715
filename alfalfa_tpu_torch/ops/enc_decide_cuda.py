"""``decide_inter_frame``: the mode and motion-vector decisions of every
macroblock of a fast rt interframe on the card, at one or several
quantizers, as the hand-written CUDA kernel ``enc_decide_row_kernel`` of
csrc/enc_decide.cu (entry ``decide_inter_frame_launch``): one launch per
call, persistent, a block per (row, quantizer) walking its row and waiting
for the row above to publish ``ROW_LAG`` macroblocks beyond its column
(csrc/row_sched.cuh).

Replaces the TPU kernel alfalfa_tpu/ops/enc_decide_pallas.py:
decide_inter_frame.  Bound, on this card, by the critical path through the
searching macroblocks' chains of diamond steps, not by bytes or
operations; it is the decide-only instantiation of K8's decision chain
(csrc/enc_inter_chain.cuh), and the source note in the .cu file says what
was kept.  Its plain version is ops.enc_decide.decide_inter_frame_plain:
``decide_inter_frame`` takes it for CPU tensors only.  A CUDA tensor
launches the kernel or raises.
"""
import ctypes
import functools

import torch

from alfalfa_tpu_torch._build import (c_entry, check_aligned, check_tensor,
                                     launch, resident_blocks)
from alfalfa_tpu_torch.ops.enc_decide import (DECIDE_WORDS,
                                              decide_inter_frame_plain)
from alfalfa_tpu_torch.ops.enc_inter import N_SCALARS

launches = 0        # op launches so far (not plain-version calls)
kernel_launches = 0  # ``<<<>>>`` launches the C entry reported issuing

TABLE_SHAPES = ((6, 4), (256,), (256,), (4, 1024))

# Macroblock (r, c) waits until row r - 1 has published min(c + ROW_LAG, C)
# macroblocks: it reads its left, above and above-left neighbours
# (d = r + c).
ROW_LAG = 1


@functools.cache
def _entry():
    return c_entry("enc_decide", "decide_inter_frame_launch",
                   [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p, ctypes.c_int])


def resident(device):
    """Blocks of the kernel the card ``device`` holds at once."""
    return resident_blocks("enc_decide", "decide_inter_frame_resident",
                           device)


def decide_inter_frame(oy, ly, scalars, icost, tables):
    """The decisions of every macroblock of an interframe, once per
    quantizer (rt: NEWMV searched where row and column are multiples of 4).

    oy: (16R, 16C) uint8 original luma, padded to whole macroblocks; ly:
    the LAST reference's luma, the same shape; scalars: (Q, N_SCALARS)
    int32 (ops/enc_inter.py's layout); icost: (Q, R*C) int32 intra cost of
    each macroblock (ops/enc_batch.intra_screen_source); tables:
    (MV_COUNTS_TO_PROBS (6, 4), PROB_COST (256,), SAD mv costs (256,), mv
    component costs (4, 1024)) int32.

    Returns (Q, R, C, DECIDE_WORDS) int32: is_inter, mode, mvx, mvy, the
    diamond sites evaluated, the candidates scored, the six-tap taps of
    their luma predictions, 0."""
    if oy.device.type != "cuda":
        return decide_inter_frame_plain(oy, ly, scalars, icost, tables)
    global launches, kernel_launches
    dev = oy.device
    H, W = oy.shape
    if H % 16 or W % 16:
        raise ValueError("oy must be padded to whole macroblocks, got %s"
                         % (tuple(oy.shape),))
    R, C = H // 16, W // 16
    Q = scalars.shape[0]
    if Q < 1:
        raise ValueError("no quantizer to decide at")
    check_tensor("oy", oy, torch.uint8, (H, W), dev)
    check_tensor("ly", ly, torch.uint8, (H, W), dev)
    check_aligned(oy=(oy, 16))
    check_tensor("scalars", scalars, torch.int32, (Q, N_SCALARS), dev)
    check_tensor("icost", icost, torch.int32, (Q, R * C), dev)
    for i, (t, shape) in enumerate(zip(tables, TABLE_SHAPES)):
        check_tensor("tables[%d]" % i, t, torch.int32, shape, dev)
    md = torch.empty((Q, R, C, DECIDE_WORDS), dtype=torch.int32, device=dev)
    # the ticket, then each row's progress (zeroed: one memset)
    sched = torch.zeros(1 + Q * R, dtype=torch.int32, device=dev)
    issued = launch(_entry(), "decide_inter_frame", dev,
                    *(t.data_ptr() for t in (oy, ly, scalars, icost, *tables,
                                             md)), Q, R, C, sched.data_ptr(),
                    ROW_LAG)
    launches += 1
    kernel_launches += issued
    return md
