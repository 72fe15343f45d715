"""``intra_fixup_frame``: the whole-mode intra encode of the macroblocks
that K9 left intra in a fast rt interframe, on the card, at one or several
quantizers, as the hand-written CUDA kernel ``enc_fixup_diag_kernel`` of
csrc/enc_intra_fixup.cu (entry ``intra_fixup_frame_launch``: one launch
per macroblock diagonal r + c, R + C - 1 per call, the quantizers on the
grid's second axis; inter macroblocks' blocks return at once).

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

from alfalfa_tpu_torch._build import c_entry, check_tensor, launch
from alfalfa_tpu_torch.ops.enc_decide import DECIDE_WORDS
from alfalfa_tpu_torch.ops.enc_inter import N_SCALARS
from alfalfa_tpu_torch.ops.enc_intra_fixup import (FIXUP_WORDS,
                                                   intra_fixup_frame_plain)

launches = 0        # op launches so far (not plain-version calls)
kernel_launches = 0  # ``<<<>>>`` launches the C entry reported issuing


@functools.cache
def _entry():
    return c_entry("enc_intra_fixup", "intra_fixup_frame_launch",
                   [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3)


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
    # intra macroblocks are encoded in place in the copies: inter ones are
    # final already
    Y, U, V = y.clone(), u.clone(), v.clone()
    coeffs = torch.zeros((Q, R, C, 25, 16), dtype=torch.int16, device=dev)
    modes = torch.zeros((Q, R, C, FIXUP_WORDS), dtype=torch.int32,
                        device=dev)
    issued = launch(_entry(), "intra_fixup_frame", dev,
                    *(t.data_ptr() for t in (oy, ou, ov, md, Y, U, V, coeffs,
                                             modes, scalars, mbc)), Q, R, C)
    launches += 1
    kernel_launches += issued
    return coeffs, modes, Y, U, V
