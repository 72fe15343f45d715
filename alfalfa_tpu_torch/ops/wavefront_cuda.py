"""``wavefront_decode``: intra prediction and loop filter of G frames in
lockstep, as the hand-written CUDA kernels of csrc/wavefront.cu.

Replaces the TPU kernel alfalfa_tpu/ops/wavefront_pm.py:
wavefront_frame_batch_pm; the source note in the .cu file says what was
kept, what bounds it and what the design does about it.  Its plain version
is ops.wavefront.wavefront_decode_plain: ``wavefront_decode`` takes it for
CPU tensors only.  A CUDA tensor launches the kernels or raises.

One call enqueues its kernel launches from C (one per diagonal and phase,
plus one) and counts as one launch of the op; ``kernel_launches`` sums the
number the C entry reports having issued.
"""
import ctypes

import torch

from alfalfa_tpu_torch._build import check_tensor
from alfalfa_tpu_torch.ops.wavefront import wavefront_decode_plain

launches = 0        # op launches so far (not plain-version calls)
kernel_launches = 0  # ``<<<>>>`` launches the C entry reported issuing
_fn = None

NP = 12             # int16 words per macroblock, see csrc/wavefront.cu


def _entry():
    global _fn
    if _fn is None:
        from alfalfa_tpu_torch._build import load_kernel
        fn = load_kernel("wavefront").wavefront_decode_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        _fn = fn
    return _fn


def pack_mb_params(ymode, uvmode, has_nonzero, intra_mask, lf_params):
    """The per-macroblock parameter words the kernels read:
    (G, R, C, NP) int16."""
    level, interior, mb_limit, sb_limit, hev, skip_sb = lf_params
    i16 = lambda x: x.to(torch.int16)
    z = torch.zeros_like(ymode, dtype=torch.int16)
    return torch.stack(
        [i16(ymode), i16(uvmode), i16(has_nonzero), i16(intra_mask),
         i16(level), i16(interior), i16(mb_limit), i16(sb_limit), i16(hev),
         i16(skip_sb), z, z], dim=-1).contiguous()


def wavefront_decode(y, u, v, res_y, res_u, res_v, ymode, uvmode, bmode,
                     has_nonzero, intra_mask, lf_params):
    """Finish G frames after the dense stages.

    y: (G, R, C, 16, 16), u, v: (G, R, C, 8, 8) uint8 stage-B tiles (inter
    macroblocks final before filtering, intra macroblocks don't-care);
    res_y/res_u/res_v: int16 residual tiles of the same shapes (B_PRED
    reads its 4x4 blocks out of the assembled res_y, so no second,
    sub-block layout is passed); ymode, uvmode: (G, R, C) int; bmode:
    (G, R, C, 16) uint8; has_nonzero, intra_mask: (G, R, C) bool;
    lf_params: (level, interior, mb_limit, sb_limit, hev, skip_sb), each
    (G, R, C) (level 0 = macroblock not filtered).

    Returns decoded, loop-filtered (G, 16R, 16C), (G, 8R, 8C), (G, 8R, 8C)
    uint8 planes."""
    if y.device.type != "cuda":
        return wavefront_decode_plain(y, u, v, res_y, res_u, res_v, ymode,
                                      uvmode, bmode, has_nonzero, intra_mask,
                                      lf_params)
    global launches, kernel_launches
    G, R, C = ymode.shape
    dev = y.device
    for name, t, dt, S in (("y", y, torch.uint8, 16), ("u", u, torch.uint8, 8),
                           ("v", v, torch.uint8, 8),
                           ("res_y", res_y, torch.int16, 16),
                           ("res_u", res_u, torch.int16, 8),
                           ("res_v", res_v, torch.int16, 8)):
        check_tensor(name, t, dt, (G, R, C, S, S), dev)
    check_tensor("bmode", bmode, torch.uint8, (G, R, C, 16), dev)
    for name, t in (("ymode", ymode), ("uvmode", uvmode), ("has_nonzero", has_nonzero),
                    ("intra_mask", intra_mask)) \
            + tuple(("lf_params[%d]" % i, t) for i, t in enumerate(lf_params)):
        if t.device != dev or tuple(t.shape) != (G, R, C):
            raise ValueError("%s must be (G, R, C) on %s" % (name, dev))
    mbp = pack_mb_params(ymode, uvmode, has_nonzero, intra_mask, lf_params)
    Y = torch.empty((G, R * 16, C * 16), dtype=torch.uint8, device=dev)
    U = torch.empty((G, R * 8, C * 8), dtype=torch.uint8, device=dev)
    V = torch.empty((G, R * 8, C * 8), dtype=torch.uint8, device=dev)
    issued = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = _entry()(Y.data_ptr(), U.data_ptr(), V.data_ptr(),
                      y.data_ptr(), u.data_ptr(), v.data_ptr(),
                      res_y.data_ptr(), res_u.data_ptr(), res_v.data_ptr(),
                      mbp.data_ptr(), bmode.data_ptr(), G, R, C,
                      torch.cuda.current_stream().cuda_stream,
                      ctypes.byref(issued))
    if rc != 0:
        raise RuntimeError("wavefront_decode launch failed: CUDA error %d"
                           % rc)
    launches += 1
    kernel_launches += issued.value
    return Y, U, V
