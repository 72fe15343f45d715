"""Six-tap motion compensation as the hand-written CUDA kernel
csrc/sixtap_mc.cu, through two entry points:

- ``mc_tiles``: one plane of G frames (the GOP decoder).  Replaces the TPU
  kernel alfalfa_tpu/ops/sixtap_pallas.py:mc_tiles_packed; plain version
  ops.sixtap.mc_tiles_plain.
- ``predict_mb_tiles``: one plane of one frame (the single-frame decoder).
  Replaces the TPU kernel alfalfa_tpu/ops/sixtap_pallas.py:mc_tiles (the
  same function on padded, unpacked references); plain version
  ops.sixtap.predict_frame_plain (ops.sixtap.predict_mb_tiles on the
  three references).  It launches the same kernel at G=1.
  ``predict_last_tiles`` is its call with every macroblock predicted from
  LAST (the fast interframe encoder), on that one plane, uncopied; it
  keeps predict_mb_tiles' counts.

The source note in the .cu file says what was kept and what bounds it.
Each takes its plain version for CPU tensors only; a CUDA tensor launches
the kernel or raises.  Each keeps its own counts.
"""
import ctypes
import functools

import torch

from alfalfa_tpu_torch._build import c_entry, check_tensor, launch
from alfalfa_tpu_torch.ops.sixtap import mc_tiles_plain, predict_frame_plain

launches = 0        # mc_tiles launches so far (not plain-version calls)
kernel_launches = 0  # ``<<<>>>`` launches the C entry reported, for mc_tiles
predict_launches = 0         # the same two counts for predict_mb_tiles
predict_kernel_launches = 0


@functools.cache
def _entry():
    return c_entry("sixtap_mc", "sixtap_mc_launch",
                   [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6)


def _launch(name, refs, ref_sel, sub_mv, S, slots=3):
    """Check the (G, ...) arguments and launch the kernel once; returns
    (G, R, C, S, S) uint8 and the kernel launches issued.  ``slots`` = 1
    hands the kernel LAST alone: only for G = 1 and every ref_sel 0 or 1,
    which read slot 0 of frame 0 and nothing else."""
    if S not in (8, 16):
        raise ValueError("S must be 8 or 16")
    G, R, C = ref_sel.shape
    n = S // 4
    dev = refs.device
    check_tensor("refs", refs, torch.uint8, (G, slots, R * S, C * S), dev)
    check_tensor("ref_sel", ref_sel, torch.int32, (G, R, C), dev)
    check_tensor("sub_mv", sub_mv, torch.int32, (G, R, C, n, n, 2), dev)
    out = torch.empty((G, R, C, S, S), dtype=torch.uint8, device=dev)
    issued = launch(_entry(), name, dev, refs.data_ptr(), ref_sel.data_ptr(),
                    sub_mv.data_ptr(), out.data_ptr(), G, R, C, R * S, C * S,
                    S)
    return out, issued


def mc_tiles(refs, ref_sel, sub_mv, S):
    """Motion-compensate every macroblock tile of one plane.

    refs: (G, 3, H, W) uint8 reference planes (last, golden, alternate),
    H = R*S, W = C*S; ref_sel: (G, R, C) int32, 0 = intra (predicted from
    ``last``; the caller masks it), 1..3 = last/golden/alternate; sub_mv:
    (G, R, C, S/4, S/4, 2) int32 eighth-pel (x, y) per 4x4 block; S: 16
    (luma) or 8 (chroma).  Returns (G, R, C, S, S) uint8 predictions."""
    if refs.device.type != "cuda":
        return mc_tiles_plain(refs, ref_sel, sub_mv, S)
    global launches, kernel_launches
    out, issued = _launch("sixtap_mc", refs, ref_sel, sub_mv, S)
    launches += 1
    kernel_launches += issued
    return out


def predict_mb_tiles(refs, ref_sel, sub_mv, S):
    """Motion-compensate every macroblock tile of one plane of one frame.

    refs: (3, H, W) uint8 (last, golden, alternate); ref_sel: (R, C)
    int32, 0 = intra (predicted from ``last``; the caller masks it),
    1..3 = last/golden/alternate; sub_mv: (R, C, S/4, S/4, 2) int32; S: 16
    or 8.  Returns (R, C, S, S) uint8 predictions."""
    if refs.device.type != "cuda":
        return predict_frame_plain(refs, ref_sel, sub_mv, S)
    global predict_launches, predict_kernel_launches
    out, issued = _launch("predict_mb_tiles", refs[None], ref_sel[None],
                          sub_mv[None], S)
    predict_launches += 1
    predict_kernel_launches += issued
    return out[0]


def predict_last_tiles(last, sub_mv, S):
    """predict_mb_tiles with every macroblock predicted from ``last``
    ((H, W) uint8, the one reference plane; ref_sel 0 everywhere): (R, C,
    S, S) uint8."""
    R, C = sub_mv.shape[:2]
    sel = torch.zeros((R, C), dtype=torch.int32, device=last.device)
    if last.device.type != "cuda":
        return predict_frame_plain(last.expand((3,) + last.shape), sel,
                                   sub_mv, S)
    global predict_launches, predict_kernel_launches
    out, issued = _launch("predict_mb_tiles", last[None, None], sel[None],
                          sub_mv[None], S, slots=1)
    predict_launches += 1
    predict_kernel_launches += issued
    return out[0]
