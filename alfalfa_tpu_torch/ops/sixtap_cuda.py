"""Six-tap motion compensation of the three planes in one launch, as the
hand-written CUDA kernel ``mc_planes_kernel`` of csrc/sixtap_mc.cu (entry
``mc_planes_launch``), reached through two wrappers that keep the names of
the TPU kernels' rows:

- ``mc_tiles``: G frames of the GOP decoder, each with its own (G, 3, H,
  W) reference stacks, passed as views.  Replaces the TPU kernel
  alfalfa_tpu/ops/sixtap_pallas.py:mc_tiles_packed (called there once a
  plane).
- ``predict_mb_tiles``: one frame's planes (the single-frame decoder: the
  three reference rasters' planes as they are), or one frame's LAST under
  Q sets of vectors (the fast interframe encoder: the plane once, batch
  stride 0).  Replaces the TPU kernel alfalfa_tpu/ops/sixtap_pallas.py:
  mc_tiles (the same function on padded, unpacked references).

Both return (y, u, v) predictions, (G, R, C, 16, 16) and twice (G, R, C,
8, 8) uint8 (on the card strided views of one buffer, each macroblock's
three tiles side by side).  The source note in the .cu file says what was kept and what
bounds it.  Each takes the plain version ``ops.sixtap.mc_planes_plain``
for CPU tensors only; a CUDA tensor launches the kernel or raises.  Each
keeps its own counts.
"""
import ctypes
import functools
import struct

import torch

from alfalfa_tpu_torch._build import c_entry, launch
from alfalfa_tpu_torch.ops.sixtap import mc_planes_plain

launches = 0        # mc_tiles launches so far (not plain-version calls)
kernel_launches = 0  # ``<<<>>>`` launches the C entry reported, for mc_tiles
predict_launches = 0         # the same two counts for predict_mb_tiles
predict_kernel_launches = 0

PLANES = (("y", 16), ("u", 8), ("v", 8))


# the C entry's arguments before the stream: the parameter words (28
# int64, packed by _WORDS: cheaper than a ctypes array), G, R, C
ARGTYPES = [ctypes.c_char_p] + [ctypes.c_int] * 3
_WORDS = struct.Struct("28q")


@functools.cache
def _entry():
    return c_entry("sixtap_mc", "mc_planes_launch", ARGTYPES)


def _fail(name, what):
    raise ValueError("%s: %s" % (name, what))


def _frame(plane, slot, t, G, H, W, dev):
    """(data pointer, batch stride in bytes) of a reference slot: an
    (H, W) plane, or (G, H, W) frames (stride 0: one frame for all) of
    contiguous rows, on ``dev``, uint8, 8-byte aligned."""
    shape, st = t.shape, t.stride()
    if len(shape) == 2:
        h, w = shape
        sh, sw = st
        stride = 0
    elif len(shape) == 3 and shape[0] == G:
        _, h, w = shape
        stride, sh, sw = st
        stride = stride if G > 1 else 0
    else:
        h = None
    if h != H or w != W or sh != W or sw != 1 or t.dtype != torch.uint8 \
            or t.device != dev:
        raise (TypeError if t.dtype != torch.uint8 else ValueError)(
            "refs[%r][%d]: expected (%d, %d) uint8 planes of contiguous "
            "rows, or %d of them, on %s" % (plane, slot, H, W, G, dev))
    ptr = t.data_ptr()
    if ptr % 8 or stride % 8:
        _fail("refs[%r][%d]" % (plane, slot),
              "frames must start on a multiple of 8 bytes")
    return ptr, stride


def _stack(plane, t, G, H, W, dev):
    """The three slots' data pointers and batch stride of a (G, 3, H, W)
    uint8 reference stack, contiguous, on ``dev``."""
    if t.dtype != torch.uint8 or t.device != dev \
            or t.shape != (G, 3, H, W) or not t.is_contiguous() \
            or t.data_ptr() % 8:
        _fail("refs[%r]" % plane, "must be a contiguous (%d, 3, %d, %d) "
              "uint8 stack on %s, 8-byte aligned" % (G, H, W, dev))
    ptr = t.data_ptr()
    return (ptr, ptr + H * W, ptr + 2 * H * W), 3 * H * W if G > 1 else 0


def _vectors(name, t, G, R, C, n, dev):
    """(data pointer, macroblock stride, 4x4-block stride) of (G, R, C, n,
    n, 2) int32 vectors: any macroblock stride m with (R C m, C m, m) over
    the first three axes, any block stride b with (n b, b) over the next
    two (0: one vector for the macroblock), pairs contiguous."""
    shape = t.shape
    if t.dtype != torch.int32 or t.device != dev \
            or shape != (G, R, C, n, n, 2):
        raise TypeError("%s must be (%d, %d, %d, %d, %d, 2) int32 on %s, not "
                        "%s %s on %s" % (name, G, R, C, n, n, dev,
                                         tuple(shape), t.dtype, t.device))
    st = t.stride()
    m = st[2] if C > 1 else st[1] if R > 1 else st[0] // (R * C)
    b = st[4]
    want = (R * C * m, C * m, m, n * b, b, 1)
    if st != want and any(x != y and k > 1
                          for x, y, k in zip(st, want, shape)):
        _fail(name, "strides %s are not (R C m, C m, m, n b, b, 1)" % (st,))
    return t.data_ptr(), m, b


def _mc_planes(name, refs, ref_sel, sub_mv, uv_mv):
    """Check the arguments (refs: each plane's (G, 3, H, W) stack, or its
    slots as predict_mb_tiles takes them), launch the kernel once; returns
    the three prediction tensors and the kernel launches issued."""
    G, R, C = sub_mv.shape[:3]
    dev = sub_mv.device
    ptrs, strides = [], []      # the C entry's first 18 parameter words
    for p, S in PLANES:
        slots, H, W = refs[p], R * S, C * S
        if isinstance(slots, torch.Tensor):
            three, stride = _stack(p, slots, G, H, W, dev)
            ptrs += three
            strides += (stride, stride, stride)
            continue
        n = len(slots)
        if n != 3 and (ref_sel is not None or n == 0):
            _fail("refs[%r]" % p, "three slots (without ref_sel, one will "
                  "do)")
        prev = None
        for k in range(3):
            t = slots[k] if k < n else slots[-1]
            if t is not prev:     # a raster in several slots: checked once
                ptr, stride = _frame(p, k, t, G, H, W, dev)
                prev = t
            ptrs.append(ptr)
            strides.append(stride)
    sel = 0
    if ref_sel is not None:
        if ref_sel.dtype != torch.int32 or ref_sel.device != dev \
                or ref_sel.shape != (G, R, C) or not ref_sel.is_contiguous():
            _fail("ref_sel", "must be (%d, %d, %d) int32, contiguous, on %s"
                  % (G, R, C, dev))
        sel = ref_sel.data_ptr()
    y_ptr, y_mb, y_blk = _vectors("sub_mv", sub_mv, G, R, C, 4, dev)
    c_ptr, c_mb, c_blk = _vectors("uv_mv", uv_mv, G, R, C, 2, dev)
    # one allocation: each macroblock's three tiles side by side (the
    # kernel's MC_TILES), a strided view a plane
    buf = torch.empty((G, R, C, 384), dtype=torch.uint8, device=dev)
    out = buf.data_ptr()
    mb = (R * C * 384, C * 384, 384)
    y = buf.as_strided((G, R, C, 16, 16), mb + (16, 1))
    u = buf.as_strided((G, R, C, 8, 8), mb + (8, 1), 256)
    v = buf.as_strided((G, R, C, 8, 8), mb + (8, 1), 320)
    words = _WORDS.pack(*ptrs, *strides, out, out + 256, out + 320, sel,
                        y_ptr, c_ptr, y_mb, y_blk, c_mb, c_blk)
    return (y, u, v), launch(_entry(), name, dev, words, G, R, C)


def mc_tiles(refs, ref_sel, sub_mv, uv_mv):
    """Motion-compensate every macroblock of the three planes of G frames
    (the GOP decoder).

    refs: {"y", "u", "v"} -> (G, 3, H, W) uint8 reference stacks (last,
    golden, alternate), H = 16R or 8R, W likewise; ref_sel: (G, R, C)
    int32, 0 = intra (predicted from ``last``; the caller masks it), 1..3 =
    last/golden/alternate; sub_mv: (G, R, C, 4, 4, 2), uv_mv: (G, R, C, 2,
    2, 2) int32 eighth-pel (x, y) per 4x4 block.  Returns the (G, R, C, 16,
    16), (G, R, C, 8, 8), (G, R, C, 8, 8) uint8 predictions."""
    if sub_mv.device.type != "cuda":
        return mc_planes_plain(refs, ref_sel, sub_mv, uv_mv)
    global launches, kernel_launches
    out, issued = _mc_planes("mc_tiles", refs, ref_sel, sub_mv, uv_mv)
    launches += 1
    kernel_launches += issued
    return out


def predict_mb_tiles(refs, ref_sel, sub_mv, uv_mv):
    """Motion-compensate every macroblock of the three planes of one frame,
    or of one frame under G sets of vectors.

    refs: {"y", "u", "v"} -> three reference slots (last, golden,
    alternate), each an (H, W) uint8 plane (one frame for all G) or (G, H,
    W) frames; with ref_sel None, every macroblock is predicted from the
    first slot, which may then come alone.  ref_sel: (G, R, C) int32 as
    mc_tiles takes it, or None; sub_mv, uv_mv: as mc_tiles takes them, of
    any strides that keep a macroblock's vectors at one stride and its
    4x4 blocks at another (an expanded view of one vector a macroblock
    will do).  Returns mc_tiles' three predictions."""
    if sub_mv.device.type != "cuda":
        return mc_planes_plain(refs, ref_sel, sub_mv, uv_mv)
    global predict_launches, predict_kernel_launches
    out, issued = _mc_planes("predict_mb_tiles", refs, ref_sel, sub_mv,
                             uv_mv)
    predict_launches += 1
    predict_kernel_launches += issued
    return out
