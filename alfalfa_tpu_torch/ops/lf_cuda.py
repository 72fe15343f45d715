"""``loop_filter``: the VP8 normal loop filter of whole planes of G
frames, as the hand-written CUDA kernel ``lf_row_kernel`` of
csrc/wavefront.cu (entry ``loop_filter_launch``): one launch per call,
persistent, a warp per (row, frame) walking its row and waiting, before a
macroblock's horizontal edges (its vertical ones read only its own row),
for the same frame's row above to publish ``ROW_LAG`` macroblocks beyond
its column (csrc/row_sched.cuh); each macroblock copies its own pixels from
the input as it goes, and keeps its last columns in shared memory as the
next one's left halo.

Replaces the TPU kernel alfalfa_tpu/ops/lf_pallas.py:lf_pallas.  Bound, on
this card, by the critical path: 2*(R-1) + C macroblocks one after
another, each a wait, an L2 load and the horizontal edges; the source note in the
.cu file says what was kept.  Its plain version is
ops.wavefront.loop_filter_plain: ``loop_filter`` takes it for CPU tensors
only.  A CUDA tensor launches the kernel or raises.

The result is written into fresh planes, never into the input: references
alias each other (a key frame is last, golden and alternate at once), so a
frame's planes never change after they are made.
"""
import ctypes
import functools

import torch

from alfalfa_tpu_torch._build import (c_entry, check_aligned, check_map,
                                     check_tensor, launch, resident_blocks)
from alfalfa_tpu_torch.ops.wavefront import loop_filter_plain
from alfalfa_tpu_torch.ops.wavefront_cuda import empty_planes, pack_mb_params

launches = 0        # op launches so far (not plain-version calls)
kernel_launches = 0  # ``<<<>>>`` launches the C entry reported issuing

# Macroblock (r, c) waits until row r - 1 has published min(c + ROW_LAG, C)
# macroblocks: (r-1, c+1)'s left edge writes pixels of (r-1, c) that the
# top edge of (r, c) reads (d = 2r + c).
ROW_LAG = 2

# the C entry's arguments before the stream: planes out, planes in, whether
# they hold G frames, the words, G, R, C, the schedule
ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]
            + [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_int])


@functools.cache
def _entry():
    return c_entry("wavefront", "loop_filter_launch", ARGTYPES)


def resident(device):
    """Blocks (warps) of the kernel the card ``device`` holds at once."""
    return resident_blocks("wavefront", "loop_filter_resident", device)


def _frames(name, t, G, shape, dev):
    """Whether ``t`` holds G frames of ``shape`` (contiguous) rather than
    one frame broadcast over G (``frame.expand(G, ...)``: batch stride 0);
    raises if it is neither."""
    if G > 1 and t.dim() == 3 and t.stride(0) == 0:
        check_tensor(name + "[0]", t[0], torch.uint8, shape, dev)
        return False
    check_tensor(name, t, torch.uint8, (G,) + shape, dev)
    return True


def loop_filter(y, u, v, lf_params):
    """Loop-filter G frames.

    y: (G, 16R, 16C), u, v: (G, 8R, 8C) uint8 planes, reconstructed and
    unfiltered, each contiguous or one frame broadcast over G (all three
    alike); lf_params: (level, interior, mb_limit, sb_limit, hev,
    skip_sb), each (G, R, C) (level 0 = macroblock not filtered, skip_sb =
    no sub-block edges; left and top edges are filtered where the
    macroblock has a neighbour there).  Returns new filtered planes of the
    same shapes."""
    if y.device.type != "cuda":
        return loop_filter_plain(y, u, v, lf_params)
    global launches, kernel_launches
    G, R, C = lf_params[0].shape
    dev = y.device
    batch = {_frames(n, t, G, (R * S, C * S), dev)
             for n, t, S in (("y", y, 16), ("u", u, 8), ("v", v, 8))}
    if len(batch) != 1:
        raise ValueError("y, u and v must all hold G frames, or all one")
    check_aligned(y=(y, 16), u=(u, 8), v=(v, 8))
    for i, t in enumerate(lf_params):
        check_map("lf_params[%d]" % i, t, (G, R, C), dev)
    mbp = pack_mb_params(lf_params=lf_params)
    Y, U, V = empty_planes(G, R, C, dev)
    # the ticket, then each (frame, row)'s progress (zeroed: one memset)
    sched = torch.zeros(1 + G * R, dtype=torch.int32, device=dev)
    issued = launch(_entry(), "loop_filter", dev,
                    Y.data_ptr(), U.data_ptr(), V.data_ptr(),
                    y.data_ptr(), u.data_ptr(), v.data_ptr(),
                    int(batch.pop()), mbp.data_ptr(), G, R, C,
                    sched.data_ptr(), ROW_LAG)
    launches += 1
    kernel_launches += issued
    return Y, U, V
