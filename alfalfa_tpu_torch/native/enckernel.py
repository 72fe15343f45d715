"""ctypes loader for the native encode kernels (enckernel.cc, built with
g++ on first use): the forward DCT of a residual, quantization and the
inverse DCT added into a plane, the 4x4 intra prediction and the B_PRED
mode search of the host intra encoder (encoder/encode_intra_np.py), which
the fast path's host patch runs.

Unlike the JAX package's loader, this one has no quiet fallback: a failed
build raises, and the numpy bodies (``transforms_np.subtract_fdct_plain``,
``quantize_plain``, ``reconstruct_np.idct_add_plain``,
``encode_intra_np.bpred_predict_plain``, ``bpred_search_plain``) serve
only as the plain versions the tests hold these functions against."""
import ctypes
import os

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "enckernel.cc")

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    from alfalfa_tpu_torch.native._build import load_library
    lib = load_library(_SRC)
    lib.vp8_subtract_fdct.restype = None
    lib.vp8_subtract_fdct.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_void_p]
    lib.vp8_idct_add.restype = None
    lib.vp8_idct_add.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int]
    lib.vp8_quantize.restype = None
    lib.vp8_quantize.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_void_p]
    lib.vp8_bpred_search.restype = ctypes.c_int
    lib.vp8_bpred_search.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_int] * 5
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
           ctypes.c_int64, ctypes.c_void_p])
    lib.vp8_bpred_predict.restype = None
    lib.vp8_bpred_predict.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 6
                                      + [ctypes.c_void_p])
    _lib = lib
    return lib


def _rows(a):
    """A (4, 4) uint8 block whose rows may be strided but whose bytes
    within a row are adjacent."""
    if a.dtype != np.uint8 or a.strides[1] != 1:
        a = np.ascontiguousarray(a, np.uint8)
    return a


def subtract_fdct(block4, pred4):
    """(block4 - pred4) -> forward 4x4 DCT coefficients, int16[16]."""
    lib = _load()
    block4, pred4 = _rows(block4), _rows(pred4)
    out = np.empty(16, np.int16)
    lib.vp8_subtract_fdct(block4.ctypes.data, block4.strides[0],
                          pred4.ctypes.data, pred4.strides[0],
                          out.ctypes.data)
    return out


def idct_add(coeffs16, target4x4):
    """4x4 inverse DCT of ``coeffs16`` added into the uint8 block
    ``target4x4`` in place (a view into a plane: rows may be strided)."""
    lib = _load()
    if target4x4.dtype != np.uint8 or target4x4.strides[1] != 1:
        raise ValueError("idct_add writes into a uint8 block with adjacent "
                         "bytes in a row")
    c = np.ascontiguousarray(coeffs16, np.int16)
    lib.vp8_idct_add(c.ctypes.data, target4x4.ctypes.data,
                     target4x4.strides[0])


def quantize(coeffs16, dc, ac):
    """Truncating division by ``dc`` at position 0 and ``ac`` elsewhere
    -> int16[16]."""
    lib = _load()
    c = np.ascontiguousarray(coeffs16, np.int16)
    out = np.empty(16, np.int16)
    lib.vp8_quantize(c.ctypes.data, int(dc), int(ac), out.ctypes.data)
    return out


def _plane(plane):
    """A uint8 plane the C code may read by row stride."""
    if plane.dtype != np.uint8 or plane.strides[1] != 1:
        raise ValueError("the B_PRED kernels read a uint8 plane with "
                         "adjacent bytes in a row")
    return plane


def bpred_predict(plane, col4, row4, mode):
    """The 4x4 prediction (uint8) of b-mode ``mode`` at sub-block (row4,
    col4) from the reconstructed ``plane``, which is not written."""
    lib = _load()
    plane = _plane(plane)
    h, w = plane.shape
    out = np.empty((4, 4), np.uint8)
    lib.vp8_bpred_predict(plane.ctypes.data, h, w, plane.strides[0],
                          int(col4), int(row4), int(mode), out.ctypes.data)
    return out


def bpred_search(plane, col4, row4, orig4, mode_costs, rate_mult, dist_mult):
    """The b-mode of least RD cost (rate x mode cost + distortion x SSE;
    the first of equal ones) for the 4x4 block ``orig4`` at (row4, col4)
    predicted from ``plane``, and its prediction: (mode, (4, 4) uint8)."""
    lib = _load()
    plane, orig4 = _plane(plane), _rows(orig4)
    h, w = plane.shape
    pred = np.empty((4, 4), np.uint8)
    costs = np.ascontiguousarray(mode_costs, np.int64)
    mode = lib.vp8_bpred_search(plane.ctypes.data, h, w, plane.strides[0],
                                int(col4), int(row4), orig4.ctypes.data,
                                orig4.strides[0], costs.ctypes.data,
                                int(rate_mult), int(dist_mult),
                                pred.ctypes.data)
    return mode, pred
