"""``intra_fixup_frame``: the whole-mode intra encode of the macroblocks
that K9 left intra in a fast rt interframe, on the card, at one or several
quantizers, as the hand-written CUDA kernel ``enc_fixup_row_kernel`` of
csrc/enc_intra_fixup.cu (entry ``intra_fixup_frame_launch``): one launch
per call, persistent, a block per (row, quantizer) that copies its row's
inter macroblocks and then walks its intra ones, waiting for the row above
to publish ``ROW_LAG`` macroblocks beyond the column (csrc/row_sched.cuh).

Replaces the TPU kernel alfalfa_tpu/ops/enc_intra_fixup_pallas.py:
intra_fixup_frame, with H1 (csrc/enc_transforms.cuh) inside; the source
note in the .cu file says what was kept and what bounds it.  Its plain
version is ops.enc_intra_fixup.intra_fixup_frame_plain:
``intra_fixup_frame`` takes it for CPU tensors only.  A CUDA tensor
launches the kernel or raises.
"""
import ctypes
import functools

import torch

from alfalfa_tpu_torch._build import (c_entry, check_aligned, check_tensor,
                                     launch, resident_blocks)
from alfalfa_tpu_torch.ops.enc_decide import DECIDE_WORDS
from alfalfa_tpu_torch.ops.enc_inter import N_SCALARS
from alfalfa_tpu_torch.ops.enc_intra_fixup import (FIXUP_WORDS,
                                                   intra_fixup_frame_plain)

launches = 0        # op launches so far (not plain-version calls)
kernel_launches = 0  # ``<<<>>>`` launches the C entry reported issuing


# Intra macroblock (r, c) waits until row r - 1 has published
# min(c + ROW_LAG, C) macroblocks: it reads its left, above and above-left
# neighbours (d = r + c).
ROW_LAG = 1

# the C entry's arguments before the stream: originals, decisions, planes
# in, planes out, coefficients, modes, scalars, mode costs; Q, R, C; the
# schedule
ARGTYPES = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 3
            + [ctypes.c_void_p, ctypes.c_int])


@functools.cache
def _entry():
    return c_entry("enc_intra_fixup", "intra_fixup_frame_launch", ARGTYPES)


def resident(device):
    """Blocks of the kernel the card ``device`` holds at once."""
    return resident_blocks("enc_intra_fixup", "intra_fixup_frame_resident",
                           device)


def intra_fixup_frame(oy, ou, ov, md, y, u, v, scalars, mbc):
    """Encode the intra macroblocks of K9's decisions ``md`` against their
    neighbours' final reconstruction, once per quantizer.

    oy: (16R, 16C), ou / ov: (8R, 8C) uint8 original planes, padded to
    whole macroblocks; md: (Q, R, C, DECIDE_WORDS) int32 (word 0:
    is_inter); y / u / v: (Q, 16R, 16C), (Q, 8R, 8C) uint8, the inter
    macroblocks' reconstruction; scalars: (Q, N_SCALARS) int32; mbc: (5,)
    int32 interframe macroblock mode costs.

    Returns coeffs (Q, R, C, 25, 16) int16 (zero at inter macroblocks),
    modes (Q, R, C, FIXUP_WORDS) int32 [whole mode, chroma mode, any nonzero
    coefficient] (zero at inter macroblocks), and the final unfiltered
    planes (new tensors; the inputs are not written)."""
    if oy.device.type != "cuda":
        return intra_fixup_frame_plain(oy, ou, ov, md, y, u, v, scalars, mbc)
    global launches, kernel_launches
    dev = oy.device
    H, W = oy.shape
    if H % 16 or W % 16:
        raise ValueError("oy must be padded to whole macroblocks, got %s"
                         % (tuple(oy.shape),))
    R, C = H // 16, W // 16
    Q = scalars.shape[0]
    if Q < 1:
        raise ValueError("no quantizer to encode at")
    for name, t, shape in (("oy", oy, (H, W)), ("ou", ou, (H // 2, W // 2)),
                           ("ov", ov, (H // 2, W // 2)),
                           ("y", y, (Q, H, W)), ("u", u, (Q, H // 2, W // 2)),
                           ("v", v, (Q, H // 2, W // 2))):
        check_tensor(name, t, torch.uint8, shape, dev)
    check_tensor("md", md, torch.int32, (Q, R, C, DECIDE_WORDS), dev)
    check_tensor("scalars", scalars, torch.int32, (Q, N_SCALARS), dev)
    check_tensor("mbc", mbc, torch.int32, (5,), dev)
    # the originals are staged, and the inter macroblocks copied, in 8- and
    # 16-byte words
    check_aligned(oy=(oy, 16), ou=(ou, 8), ov=(ov, 8), y=(y, 16), u=(u, 8),
                  v=(v, 8))
    # written whole by the kernel: inter macroblocks copied (coefficients
    # and modes zero), intra ones encoded
    Y, U, V = (torch.empty_like(t) for t in (y, u, v))
    coeffs = torch.empty((Q, R, C, 25, 16), dtype=torch.int16, device=dev)
    modes = torch.empty((Q, R, C, FIXUP_WORDS), dtype=torch.int32,
                        device=dev)
    # the ticket, then each (quantizer, row)'s progress (zeroed: one memset)
    sched = torch.zeros(1 + Q * R, dtype=torch.int32, device=dev)
    issued = launch(_entry(), "intra_fixup_frame", dev,
                    *(t.data_ptr() for t in (oy, ou, ov, md, y, u, v, Y, U, V,
                                             coeffs, modes, scalars, mbc)),
                    Q, R, C, sched.data_ptr(), ROW_LAG)
    launches += 1
    kernel_launches += issued
    return coeffs, modes, Y, U, V
