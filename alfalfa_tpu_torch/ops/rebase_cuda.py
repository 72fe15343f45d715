"""``inter_residues``: the rebase's residue update of every inter
macroblock of one frame, as the hand-written CUDA kernel
``inter_residues_kernel`` of csrc/rebase_residues.cu (entry
``inter_residues_launch``): one launch a call, a block of 384 threads a
macroblock, a half-warp a 4x4 sub-block.

It replaces no TPU kernel: the JAX package computes the step with XLA
(alfalfa_tpu/encoder/reencode_device.py:_fn_core) around K3.  Its plain
version is ops.rebase.inter_residues_plain, which ``inter_residues`` takes
for CPU tensors only; a CUDA tensor launches the kernel or raises.  The
source note in the .cu file says what bounds it.
"""
import ctypes
import functools
import struct

import torch

from alfalfa_tpu_torch._build import c_entry, check_tensor, launch
from alfalfa_tpu_torch.ops.rebase import inter_residues_plain

launches = 0        # op launches so far (not plain-version calls)
kernel_launches = 0  # ``<<<>>>`` launches the C entry reported issuing

# the C entry's arguments before the stream: the 22 parameter words
# (packed by _WORDS), R, C
ARGTYPES = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
_WORDS = struct.Struct("22q")


@functools.cache
def _entry():
    return c_entry("rebase_residues", "inter_residues_launch", ARGTYPES)


def _tiles(name, t, R, C, S, dev):
    """(data pointer, macroblock stride) of (R, C, S, S) uint8 tiles of
    rows of S contiguous bytes, at one stride a macroblock (K3's output
    holds a macroblock's three tiles side by side)."""
    st = t.stride()
    if t.dtype != torch.uint8 or t.device != dev \
            or tuple(t.shape) != (R, C, S, S) or st[2:] != (S, 1) \
            or (R > 1 and st[0] != C * st[1]):
        raise ValueError("%s must be (%d, %d, %d, %d) uint8 tiles on %s with "
                         "rows of %d bytes and one stride a macroblock"
                         % (name, R, C, S, S, dev, S))
    return t.data_ptr(), st[1]


def inter_residues(orig, pred, ref_sel, splitmv, quant, recon):
    """Update every inter macroblock's residues (ops.rebase.
    inter_residues_plain's arguments and result): orig and recon are the
    three (16R, 16C), (8R, 8C), (8R, 8C) uint8 planes, contiguous, recon
    written in place at inter macroblocks; pred K3's three predictions;
    ref_sel (R, C) int32 and splitmv (R, C) bool, contiguous; quant the
    six factors.  Returns the (R, C, 25, 16) int16 coefficients and the
    (R, C) bool nonzero flags."""
    if ref_sel.device.type != "cuda":
        return inter_residues_plain(orig, pred, ref_sel, splitmv, quant,
                                    recon)
    global launches, kernel_launches
    R, C = ref_sel.shape
    dev = ref_sel.device
    check_tensor("ref_sel", ref_sel, torch.int32, (R, C), dev)
    check_tensor("splitmv", splitmv, torch.bool, (R, C), dev)
    for k, S in enumerate((16, 8, 8)):
        check_tensor("orig[%d]" % k, orig[k], torch.uint8, (R * S, C * S),
                     dev)
        check_tensor("recon[%d]" % k, recon[k], torch.uint8,
                     (R * S, C * S), dev)
    preds = [_tiles("pred[%d]" % k, pred[k], R, C, S, dev)
             for k, S in enumerate((16, 8, 8))]
    quant = [int(x) for x in quant]
    if len(quant) != 6 or min(quant) < 4:
        raise ValueError("quant must be the six factors, each at least 4")
    coeffs = torch.empty((R, C, 25, 16), dtype=torch.int16, device=dev)
    nonzero = torch.empty((R, C), dtype=torch.bool, device=dev)
    words = ([t.data_ptr() for t in orig] + [p for p, _ in preds]
             + [m for _, m in preds] + [t.data_ptr() for t in recon]
             + [ref_sel.data_ptr(), splitmv.data_ptr(), coeffs.data_ptr(),
                nonzero.data_ptr()] + quant)
    issued = launch(_entry(), "inter_residues", dev, _WORDS.pack(*words),
                    R, C)
    launches += 1
    kernel_launches += issued
    return coeffs, nonzero
