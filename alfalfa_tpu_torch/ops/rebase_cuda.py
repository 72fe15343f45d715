"""``rebase_frame``: the rebase's residue update of one frame (K3's
prediction and the residues of the inter macroblocks, the intra
macroblocks with their given modes), as the hand-written CUDA kernel
``rebase_row_kernel`` of csrc/rebase_residues.cu (entry
``rebase_frame_launch``): one launch per frame, persistent, as many blocks
as the card holds (or a block a row, if more), which share the frame's
inter macroblocks out in pairs and then each walk one row's intra
macroblocks, waiting for the row above to publish ``ROW_LAG_WHOLE`` or
``ROW_LAG_BPRED`` macroblocks beyond the column (csrc/row_sched.cuh).

It replaces no TPU kernel: the JAX package computes the step with XLA
around K3 (alfalfa_tpu/encoder/reencode_device.py:_fn_core) and a host
loop (alfalfa_tpu/encoder/reencode.py:_apply_intra_mb).  Its plain
version is ops.rebase.rebase_frame_plain, which ``rebase_frame`` takes for
CPU tensors only; a CUDA tensor launches the kernel or raises.  The source
note in the .cu file says what bounds it.
"""
import ctypes
import functools
import struct

import torch

from alfalfa_tpu_torch._build import (c_entry, check_aligned, check_tensor,
                                     launch, resident_blocks)
from alfalfa_tpu_torch.ops.rebase import (MB_WORDS, OUT_WORDS,
                                          rebase_frame_plain)

launches = 0        # op launches so far (not plain-version calls)
kernel_launches = 0  # ``<<<>>>`` launches the C entry reported issuing

# An intra macroblock (r, c) waits until row r - 1 has published min(c +
# lag, C) macroblocks: a whole mode reads its left, above and above-left
# neighbours (d = r + c), B_PRED also the above-right one's bottom row
# (d = 2r + c).
ROW_LAG_WHOLE, ROW_LAG_BPRED = 1, 2

# the C entry's arguments before the stream: the 23 parameter words
# (packed by _WORDS), R, C, the schedule, the two lags, the blocks
ARGTYPES = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
_WORDS = struct.Struct("23q")


@functools.cache
def _entry():
    return c_entry("rebase_residues", "rebase_frame_launch", ARGTYPES)


@functools.cache
def resident(device):
    """Blocks of the kernel the card ``device`` holds at once."""
    return resident_blocks("rebase_residues", "rebase_frame_resident",
                           device)


def check_args(orig, refs, words, quant, recon, dev):
    """Raise unless ``rebase_frame``'s arguments are what the kernel takes
    on ``dev``; returns (the nine reference slots' data pointers, plane
    by plane, the six factors as ints)."""
    R, C = words.shape[:2]
    check_tensor("words", words, torch.int32, (R, C, MB_WORDS), dev)
    for k, S in enumerate((16, 8, 8)):
        check_tensor("orig[%d]" % k, orig[k], torch.uint8, (R * S, C * S),
                     dev)
        check_tensor("recon[%d]" % k, recon[k], torch.uint8,
                     (R * S, C * S), dev)
    # the intra macroblocks' originals are staged in 16- and 8-byte words
    check_aligned(**{"orig[0]": (orig[0], 16), "orig[1]": (orig[1], 8),
                     "orig[2]": (orig[2], 8)})
    slots = []
    for k, (p, S) in enumerate((("y", 16), ("u", 8), ("v", 8))):
        if len(refs[p]) != 3:
            raise ValueError("refs[%r] must be the three slots" % p)
        for t in refs[p]:
            check_tensor("refs[%r]" % p, t, torch.uint8, (R * S, C * S), dev)
            if t.data_ptr() == recon[k].data_ptr():
                raise ValueError("refs[%r] is a recon plane" % p)
            slots.append(t.data_ptr())
    quant = [int(x) for x in quant]
    if len(quant) != 6 or min(quant) < 4:
        raise ValueError("quant must be the six factors, each at least 4")
    return slots, quant


def rebase_frame(orig, refs, words, quant, recon):
    """The residue update of one frame (ops.rebase.rebase_frame_plain's
    arguments and result): orig and recon are the three (16R, 16C), (8R,
    8C), (8R, 8C) uint8 planes, contiguous, recon written whole; refs
    {"y", "u", "v"} -> the three reference slots (last, golden, alternate),
    (H, W) uint8 planes of contiguous rows, none of them a recon plane;
    words the (R, C, MB_WORDS) int32 modes and vectors (ops.rebase.
    mb_words); quant the six factors.  Returns the (R, C, OUT_WORDS) int16
    output words (ops.rebase.split_out)."""
    if words.device.type != "cuda":
        return rebase_frame_plain(orig, refs, words, quant, recon)
    global launches, kernel_launches
    R, C = words.shape[:2]
    dev = words.device
    slots, quant = check_args(orig, refs, words, quant, recon, dev)
    out = torch.empty((R, C, OUT_WORDS), dtype=torch.int16, device=dev)
    # the row and pair tickets, then each row's progress and inter count
    # (zeroed: one memset)
    sched = torch.zeros(2 + 2 * R, dtype=torch.int32, device=dev)
    p = ([t.data_ptr() for t in orig] + [t.data_ptr() for t in recon]
         + slots + [words.data_ptr(), out.data_ptr()] + quant)
    issued = launch(_entry(), "rebase_frame", dev, _WORDS.pack(*p), R, C,
                    sched.data_ptr(), ROW_LAG_WHOLE, ROW_LAG_BPRED,
                    resident(dev))
    launches += 1
    kernel_launches += issued
    return out
