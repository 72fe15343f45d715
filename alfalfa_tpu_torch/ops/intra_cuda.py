"""``intra_frame``: intra prediction of G frames over macroblock
diagonals, as the hand-written CUDA kernels of csrc/wavefront.cu (entry
``intra_frame_launch``: the untile launch and one ``intra_diag_kernel``
launch per diagonal, no loop filter).

Replaces the TPU kernel alfalfa_tpu/ops/intra_pallas.py:intra_frame; the
source note in the .cu file says what was kept and what bounds it.  Its
plain version is ops.wavefront.intra_frame_plain: ``intra_frame`` takes it
for CPU tensors only.  A CUDA tensor launches the kernels or raises.
"""
import functools

from alfalfa_tpu_torch._build import c_entry, launch
from alfalfa_tpu_torch.ops.wavefront import intra_frame_plain
from alfalfa_tpu_torch.ops.wavefront_cuda import (
    WAVE_ARGTYPES, check_wave_inputs, empty_planes, pack_mb_params)

launches = 0        # op launches so far (not plain-version calls)
kernel_launches = 0  # ``<<<>>>`` launches the C entry reported issuing


@functools.cache
def _entry():
    return c_entry("wavefront", "intra_frame_launch", WAVE_ARGTYPES)


def intra_frame(y, u, v, res_y, res_u, res_v, ymode, uvmode, bmode,
                has_nonzero, intra_mask):
    """Reconstruct G frames from their stage-B tiles, before the loop
    filter.

    Arguments as ops.wavefront_cuda.wavefront_decode's without lf_params:
    (G, R, C, S, S) uint8 tiles and int16 residuals, (G, R, C) maps,
    (G, R, C, 16) uint8 bmode.  Returns the unfiltered (G, 16R, 16C),
    (G, 8R, 8C), (G, 8R, 8C) uint8 planes: inter macroblocks as their
    tiles, intra macroblocks predicted from their unfiltered
    neighbours."""
    if y.device.type != "cuda":
        return intra_frame_plain(y, u, v, res_y, res_u, res_v, ymode, uvmode,
                                 bmode, has_nonzero, intra_mask)
    global launches, kernel_launches
    G, R, C = ymode.shape
    dev = y.device
    check_wave_inputs(dev, G, R, C, y, u, v, res_y, res_u, res_v, bmode,
                      {"ymode": ymode, "uvmode": uvmode,
                       "has_nonzero": has_nonzero, "intra_mask": intra_mask})
    mbp = pack_mb_params(ymode, uvmode, has_nonzero, intra_mask)
    Y, U, V = empty_planes(G, R, C, dev)
    issued = launch(_entry(), "intra_frame", dev,
                    Y.data_ptr(), U.data_ptr(), V.data_ptr(),
                    y.data_ptr(), u.data_ptr(), v.data_ptr(),
                    res_y.data_ptr(), res_u.data_ptr(), res_v.data_ptr(),
                    mbp.data_ptr(), bmode.data_ptr(), G, R, C)
    launches += 1
    kernel_launches += issued
    return Y, U, V
