"""``loop_filter``: the VP8 normal loop filter of whole planes of G
frames, as the hand-written CUDA kernel ``lf_diag_kernel`` of
csrc/wavefront.cu (entry ``loop_filter_launch``: one launch per diagonal
filters all three planes).

Replaces the TPU kernel alfalfa_tpu/ops/lf_pallas.py:lf_pallas; the source
note in the .cu file says what was kept and what bounds it.  Its plain
version is ops.wavefront.loop_filter_plain: ``loop_filter`` takes it for
CPU tensors only.  A CUDA tensor launches the kernels or raises.

The result is written into fresh planes, never into the input: references
alias each other (a key frame is last, golden and alternate at once), so a
frame's planes never change after they are made.
"""
import ctypes
import functools

import torch

from alfalfa_tpu_torch._build import c_entry, check_map, check_tensor, launch
from alfalfa_tpu_torch.ops.wavefront import loop_filter_plain
from alfalfa_tpu_torch.ops.wavefront_cuda import empty_planes, pack_mb_params

launches = 0        # op launches so far (not plain-version calls)
kernel_launches = 0  # ``<<<>>>`` launches the C entry reported issuing


@functools.cache
def _entry():
    return c_entry("wavefront", "loop_filter_launch",
                   [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3)


def loop_filter(y, u, v, lf_params):
    """Loop-filter G frames.

    y: (G, 16R, 16C), u, v: (G, 8R, 8C) uint8 planes, reconstructed and
    unfiltered; lf_params: (level, interior, mb_limit, sb_limit, hev,
    skip_sb), each (G, R, C) (level 0 = macroblock not filtered, skip_sb =
    no sub-block edges; left and top edges are filtered where the
    macroblock has a neighbour there).  Returns new filtered planes of the
    same shapes."""
    if y.device.type != "cuda":
        return loop_filter_plain(y, u, v, lf_params)
    global launches, kernel_launches
    G, R, C = lf_params[0].shape
    dev = y.device
    check_tensor("y", y, torch.uint8, (G, R * 16, C * 16), dev)
    check_tensor("u", u, torch.uint8, (G, R * 8, C * 8), dev)
    check_tensor("v", v, torch.uint8, (G, R * 8, C * 8), dev)
    for i, t in enumerate(lf_params):
        check_map("lf_params[%d]" % i, t, (G, R, C), dev)
    mbp = pack_mb_params(lf_params=lf_params)
    Y, U, V = empty_planes(G, R, C, dev)
    issued = launch(_entry(), "loop_filter", dev,
                    Y.data_ptr(), U.data_ptr(), V.data_ptr(),
                    y.data_ptr(), u.data_ptr(), v.data_ptr(),
                    mbp.data_ptr(), G, R, C)
    launches += 1
    kernel_launches += issued
    return Y, U, V
