"""Key-frame macroblock encoding on the encoder's device: the host side of
the K7 kernel (ops/enc_intra_cuda.py).

One upload of the padded original planes (the caller's), the kernel, then
one device-to-host copy of the coefficients and modes into ``FrameArrays``
(the serializer and the token counts read them on the host).  The
unfiltered reconstruction stays on the device as a ``Raster`` of tensor
planes for the loop-filter search.
"""
import numpy as np
import torch

from alfalfa_tpu_torch.bitstream import tables as T
from alfalfa_tpu_torch.decoder.parse import FrameArrays
from alfalfa_tpu_torch.encoder.trellis import token_costs_pm
from alfalfa_tpu_torch.ops.enc_intra import MODE_WORDS
from alfalfa_tpu_torch.ops.enc_intra_cuda import encode_kf_frame
from alfalfa_tpu_torch.state.decoder_state import Raster
from alfalfa_tpu_torch.util import tracing

QUANT_KEYS = ("y_dc", "y_ac", "y2_dc", "y2_ac", "uv_dc", "uv_ac")


def encode_keyframe(oplanes, width, height, q, rate_mult, dist_mult,
                    trellis_probs=None):
    """Encode all macroblocks of a key frame.

    oplanes: (y, u, v) uint8 tensors, the original planes padded to whole
    macroblocks, on the device to encode on; q: the quantizer factors
    ({"y_dc": ..., ...}); trellis_probs: None, or the (4, 8, 3, 11)
    coefficient probabilities the --two-pass trellis prices tokens with.

    Returns (FrameArrays on the host, the unfiltered reconstruction as a
    Raster of tensor planes on the device)."""
    oy, ou, ov = oplanes
    dev = oy.device
    R, C = oy.shape[0] // 16, oy.shape[1] // 16
    tc = None
    if trellis_probs is not None:
        tc = torch.from_numpy(token_costs_pm(trellis_probs)).to(dev)
    with tracing.stage("enc.kf_mb_wavefront", sync=True):
        coeffs, modes, y, u, v = encode_kf_frame(
            oy, ou, ov, [q[k] for k in QUANT_KEYS], rate_mult, dist_mult, tc)
    with tracing.stage("enc.fetch"):
        # one copy: the coefficients' bytes, then the modes
        packed = torch.cat([coeffs.reshape(-1).view(torch.uint8),
                            modes.reshape(-1)]).cpu().numpy()
    tracing.count("d2h.enc_fetch", packed.nbytes)
    n = R * C * 25 * 16 * 2
    md = packed[n:].reshape(R, C, MODE_WORDS)
    arrays = FrameArrays(R, C)
    arrays.coeffs[:] = packed[:n].view(np.int16).reshape(R, C, 25, 16)
    arrays.ymode[:] = md[:, :, 0]
    arrays.uvmode[:] = md[:, :, 1]
    arrays.y2_coded[:] = md[:, :, 2] != 0
    arrays.has_nonzero[:] = md[:, :, 3] != 0
    arrays.bmode[:] = md[:, :, 4:].reshape(R, C, 4, 4)
    arrays.ref[:] = T.CURRENT_FRAME
    return arrays, Raster(width, height, y, u, v)
