"""``mc_tiles``: six-tap motion compensation of one plane for G frames,
as the hand-written CUDA kernel csrc/sixtap_mc.cu.

Replaces the TPU kernel alfalfa_tpu/ops/sixtap_pallas.py:mc_tiles_packed;
the source note in the .cu file says what was kept and what bounds it.
Its plain version is ops.sixtap.mc_tiles_plain: ``mc_tiles`` takes it for
CPU tensors only.  A CUDA tensor launches the kernel or raises.
"""
import ctypes

import torch

from alfalfa_tpu_torch._build import check_tensor
from alfalfa_tpu_torch.ops.sixtap import mc_tiles_plain

launches = 0        # op launches so far (not plain-version calls)
kernel_launches = 0  # ``<<<>>>`` launches the C entry reported issuing
_fn = None


def _entry():
    global _fn
    if _fn is None:
        from alfalfa_tpu_torch._build import load_kernel
        fn = load_kernel("sixtap_mc").sixtap_mc_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        _fn = fn
    return _fn


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
    if S not in (8, 16):
        raise ValueError("S must be 8 or 16")
    G, R, C = ref_sel.shape
    n = S // 4
    dev = refs.device
    check_tensor("refs", refs, torch.uint8, (G, 3, R * S, C * S), dev)
    check_tensor("ref_sel", ref_sel, torch.int32, (G, R, C), dev)
    check_tensor("sub_mv", sub_mv, torch.int32, (G, R, C, n, n, 2), dev)
    out = torch.empty((G, R, C, S, S), dtype=torch.uint8, device=dev)
    issued = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = _entry()(refs.data_ptr(), ref_sel.data_ptr(), sub_mv.data_ptr(),
                      out.data_ptr(), G, R, C, R * S, C * S, S,
                      torch.cuda.current_stream().cuda_stream,
                      ctypes.byref(issued))
    if rc != 0:
        raise RuntimeError("sixtap_mc launch failed: CUDA error %d" % rc)
    launches += 1
    kernel_launches += issued.value
    return out
