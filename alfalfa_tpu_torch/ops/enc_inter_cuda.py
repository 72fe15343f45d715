"""``encode_inter_frame``: every macroblock of an interframe encoded on the
card, at one or several quantizers (motion search, mode decision,
residues, plain or trellis quantization of intra macroblocks, the
unfiltered reconstruction), as the hand-written CUDA kernel
``enc_inter_row_kernel`` of csrc/enc_inter.cu (entry
``encode_inter_frame_launch``): one launch per call, persistent, a block per
(row, quantizer) walking its row and waiting for the row above to publish
``ROW_LAG`` macroblocks beyond its column (csrc/row_sched.cuh).

Replaces the TPU kernel alfalfa_tpu/ops/enc_inter_pallas.py:
encode_inter_frame with the helpers traced inside it, H1
(csrc/enc_transforms.cuh) and H2 (csrc/trellis.cuh).  Bound, on this card,
by the critical path through the macroblocks' dependences and each
search's chain of diamond steps, not by bytes or operations; the decision
chain is csrc/enc_inter_chain.cuh, shared with K9, and the source note in
the .cu file says what was kept.  Its plain version is
ops.enc_inter.encode_inter_frame_plain: ``encode_inter_frame`` takes it for
CPU tensors only.  A CUDA tensor launches the kernel or raises.
"""
import ctypes
import functools

import torch

from alfalfa_tpu_torch._build import (c_entry, check_aligned, check_tensor,
                                     launch, resident_blocks)
from alfalfa_tpu_torch.encoder.trellis import VALUE_COST
from alfalfa_tpu_torch.ops.enc_inter import (MODE_WORDS, N_SCALARS,
                                             encode_inter_frame_plain)

launches = 0        # op launches so far (not plain-version calls)
kernel_launches = 0  # ``<<<>>>`` launches the C entry reported issuing

TABLE_SHAPES = ((5,), (10,), (6, 4), (256,), (256,), (4, 1024))

# Macroblock (r, c) waits until row r - 1 has published min(c + ROW_LAG, C)
# macroblocks: its reads reach the above-right neighbour (d = 2r + c).
ROW_LAG = 2


@functools.cache
def _entry():
    return c_entry("enc_inter", "encode_inter_frame_launch",
                   [ctypes.c_void_p] * 24 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p, ctypes.c_int])


def resident(device):
    """Blocks of the kernel the card ``device`` holds at once."""
    return resident_blocks("enc_inter", "encode_inter_frame_resident", device)


@functools.cache
def _value_cost(device):
    return torch.from_numpy(VALUE_COST.astype("int32")).to(device)


def encode_inter_frame(oy, ou, ov, ly, lu, lv, scalars, tables, realtime,
                       token_costs=None):
    """Encode every macroblock of an interframe, once per quantizer.

    oy: (16R, 16C), ou / ov: (8R, 8C) uint8 original planes, padded to
    whole macroblocks; ly / lu / lv: the LAST reference's planes, the same
    shapes; scalars: (Q, N_SCALARS) int32, one row per quantizer (y_dc,
    y_ac, y2_dc, y2_ac, uv_dc, uv_ac, rate multiplier, distortion
    multiplier, SAD per bit); tables: the six int32 cost tables of
    ops.enc_inter.encode_inter_frame_plain; realtime: search NEWMV only
    where row and column are multiples of 4; token_costs: None, or the (4,
    16, 36) int32 token costs for the trellis of intra macroblocks.

    Returns coeffs (Q, R, C, 25, 16) int16, modes (Q, R, C, MODE_WORDS)
    int32 = [ymode, uvmode, is_inter, has_nonzero, mvx, mvy, chroma mvx,
    mvy, 16 b-modes, diamond sites evaluated, candidates scored, six-tap
    taps their luma predictions need, 5 zero], and the
    reconstructed, unfiltered (Q, 16R, 16C), (Q, 8R, 8C), (Q, 8R, 8C)
    uint8 planes."""
    if oy.device.type != "cuda":
        return encode_inter_frame_plain(oy, ou, ov, ly, lu, lv, scalars,
                                        tables, realtime, token_costs)
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
                           ("ov", ov, (H // 2, W // 2)), ("ly", ly, (H, W)),
                           ("lu", lu, (H // 2, W // 2)),
                           ("lv", lv, (H // 2, W // 2))):
        check_tensor(name, t, torch.uint8, shape, dev)
    check_aligned(oy=(oy, 16), ou=(ou, 8), ov=(ov, 8))
    check_tensor("scalars", scalars, torch.int32, (Q, N_SCALARS), dev)
    for i, (t, shape) in enumerate(zip(tables, TABLE_SHAPES)):
        check_tensor("tables[%d]" % i, t, torch.int32, shape, dev)
    empty = lambda shape, dt=torch.uint8: torch.empty(shape, dtype=dt,
                                                      device=dev)
    y = empty((Q, H, W))
    u, v = empty((Q, H // 2, W // 2)), empty((Q, H // 2, W // 2))
    coeffs = empty((Q, R, C, 25, 16), torch.int16)
    modes = empty((Q, R, C, MODE_WORDS), torch.int32)
    if token_costs is None:
        tc = vc = ynz = unz = vnz = y2c = None
    else:
        check_tensor("token_costs", token_costs, torch.int32, (4, 16, 36),
                     dev)
        tc, vc = token_costs, _value_cost(dev)
        # every macroblock writes its flags before a later one reads them
        ynz = empty((Q, 4 * R, 4 * C))
        unz, vnz = empty((Q, 2 * R, 2 * C)), empty((Q, 2 * R, 2 * C))
        y2c = empty((Q, R, C, 4))
    # the ticket, then each row's progress (zeroed: one memset)
    sched = torch.zeros(1 + Q * R, dtype=torch.int32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    issued = launch(_entry(), "encode_inter_frame", dev,
                    *(t.data_ptr() for t in (oy, ou, ov, ly, lu, lv, y, u, v,
                                             coeffs, modes, scalars, *tables)),
                    *(ptr(t) for t in (tc, vc, ynz, unz, vnz, y2c)),
                    int(bool(realtime)), Q, R, C, sched.data_ptr(), ROW_LAG)
    launches += 1
    kernel_launches += issued
    return coeffs, modes, y, u, v
