"""``encode_kf_frame``: every macroblock of a key frame encoded on the card
(mode decision, transforms, plain or trellis quantization, the unfiltered
reconstruction), as the hand-written CUDA kernel ``enc_kf_row_kernel`` of
csrc/enc_intra.cu (entry ``encode_kf_frame_launch``): one launch per call,
persistent, a block per row walking its row and waiting for the row above
to publish ``ROW_LAG`` macroblocks beyond its column (csrc/row_sched.cuh);
the B_PRED chain of a macroblock runs on one warp beside the whole-mode
and chroma chains, the trellis's chained blocks run their backward passes
at once.  The kernel has a one-pass and a two-pass (trellis) form; the
call takes the one its ``token_costs`` asks for.

Replaces the TPU kernel alfalfa_tpu/ops/enc_intra_pallas.py:encode_kf_frame
with the helpers traced inside it, H1 (enc_transforms_pallas.py ->
csrc/enc_transforms.cuh) and H2 (trellis_pallas.py -> csrc/trellis.cuh).
Bound, on this card, by the critical path: 2*(R-1) + C macroblocks one
after another, each its B_PRED chain of 10 dependent steps; the source
note in the .cu file says what was kept.  Its plain version is
ops.enc_intra.encode_kf_frame_plain: ``encode_kf_frame`` takes it for CPU
tensors only.  A CUDA tensor launches the kernel or raises.
"""
import ctypes
import functools

import torch

from alfalfa_tpu_torch._build import (c_entry, check_aligned, check_tensor,
                                     launch, resident_blocks)
from alfalfa_tpu_torch.encoder.trellis import VALUE_COST
from alfalfa_tpu_torch.ops.enc_intra import (MODE_WORDS, encode_kf_frame_plain,
                                             mode_costs)

launches = 0        # op launches so far (not plain-version calls)
kernel_launches = 0  # ``<<<>>>`` launches the C entry reported issuing

# Macroblock (r, c) waits until row r - 1 has published min(c + ROW_LAG, C)
# macroblocks: its B_PRED candidate reads the above-right neighbour
# (d = 2r + c).
ROW_LAG = 2

# the C entry's arguments before the stream: planes, outputs, tables and
# trellis state, the quantizers, multipliers and R, C, the schedule
ARGTYPES = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 10
            + [ctypes.c_void_p, ctypes.c_int])


@functools.cache
def _entry():
    return c_entry("enc_intra", "encode_kf_frame_launch", ARGTYPES)


def resident(device, trellis=False):
    """Blocks of the kernel (its two-pass form with ``trellis``) the card
    ``device`` holds at once."""
    return resident_blocks("enc_intra", "encode_kf_frame_resident", device,
                           int(trellis))


@functools.cache
def _tables(device):
    """The constant cost tables on ``device`` as int32: key-frame macroblock
    mode costs, b-mode costs, trellis value costs."""
    mbc, bcost = mode_costs(device)
    return (mbc.to(torch.int32).contiguous(), bcost.to(torch.int32).contiguous(),
            torch.from_numpy(VALUE_COST.astype("int32")).to(device))


def encode_kf_frame(oy, ou, ov, quant, rate_mult, dist_mult,
                    token_costs=None):
    """Encode every macroblock of a key frame.

    oy: (16R, 16C), ou / ov: (8R, 8C) uint8 original planes, padded to
    whole macroblocks; quant: the six quantizer factors (y_dc, y_ac,
    y2_dc, y2_ac, uv_dc, uv_ac); rate_mult / dist_mult: the RD
    multipliers; token_costs: None (plain quantization), or the
    (4, 16, 36) int32 position-major token costs of the frame's
    probabilities (encoder/trellis.py:token_costs_pm) for the trellis.

    Returns (coeffs (R, C, 25, 16) int16 in raster order, modes (R, C,
    MODE_WORDS) uint8 = [ymode, uvmode, y2_coded, has_nonzero, 16
    b-modes], and the reconstructed, unfiltered (16R, 16C), (8R, 8C),
    (8R, 8C) uint8 planes)."""
    if oy.device.type != "cuda":
        return encode_kf_frame_plain(oy, ou, ov, quant, rate_mult, dist_mult,
                                     token_costs)
    global launches, kernel_launches
    dev = oy.device
    H, W = oy.shape
    if H % 16 or W % 16:
        raise ValueError("oy must be padded to whole macroblocks, got %s"
                         % (tuple(oy.shape),))
    R, C = H // 16, W // 16
    check_tensor("oy", oy, torch.uint8, (H, W), dev)
    check_tensor("ou", ou, torch.uint8, (H // 2, W // 2), dev)
    check_tensor("ov", ov, torch.uint8, (H // 2, W // 2), dev)
    check_aligned(oy=(oy, 16), ou=(ou, 8), ov=(ov, 8))
    mbc, bcost, vcost = _tables(dev)
    empty = lambda shape, dt=torch.uint8: torch.empty(shape, dtype=dt,
                                                      device=dev)
    y, u, v = empty((H, W)), empty((H // 2, W // 2)), empty((H // 2, W // 2))
    coeffs = empty((R, C, 25, 16), torch.int16)
    modes = empty((R, C, MODE_WORDS))
    if token_costs is None:
        tc = vc = ynz = unz = vnz = y2c = None
    else:
        check_tensor("token_costs", token_costs, torch.int32, (4, 16, 36),
                     dev)
        tc, vc = token_costs, vcost
        # every macroblock writes its flags before a later one reads them
        ynz, unz, vnz = empty((4 * R, 4 * C)), empty((2 * R, 2 * C)), \
            empty((2 * R, 2 * C))
        y2c = empty((R, C, 4))
    # the ticket, then each row's progress (zeroed: one memset)
    sched = torch.zeros(1 + R, dtype=torch.int32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    q = [int(x) for x in quant]
    issued = launch(_entry(), "encode_kf_frame", dev,
                    oy.data_ptr(), ou.data_ptr(), ov.data_ptr(),
                    y.data_ptr(), u.data_ptr(), v.data_ptr(),
                    coeffs.data_ptr(), modes.data_ptr(), mbc.data_ptr(),
                    bcost.data_ptr(), ptr(tc), ptr(vc), ptr(ynz), ptr(unz),
                    ptr(vnz), ptr(y2c), *q, int(rate_mult), int(dist_mult),
                    R, C, sched.data_ptr(), ROW_LAG)
    launches += 1
    kernel_launches += issued
    return coeffs, modes, y, u, v
