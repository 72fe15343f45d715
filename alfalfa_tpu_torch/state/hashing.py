"""State hashing, interoperable with the oracle build's hash scheme.

The reference addresses codec states by a 64-bit hash collapsed to a 32-bit
"minihash" which is stamped into IVF headers and Salsify packets
(reference decoder/decoder.cc:516-529, util/ivf_writer.cc:92-99).  We keep
the same mechanism and the same combiner (classic golden-ratio hash_combine;
see oracle/stubs/boost/functional/hash.hpp) so fixtures generated by the
oracle verify against framework-computed hashes.
"""
import numpy as np

MASK64 = 0xFFFFFFFFFFFFFFFF


def hash_combine(seed, value):
    """seed ^= value + 0x9e3779b9 + (seed << 6) + (seed >> 2), in uint64."""
    return (seed ^ ((value + 0x9E3779B9 + ((seed << 6) & MASK64) + (seed >> 2))
                    & MASK64)) & MASK64


def hash_range(seed, values):
    """Sequentially hash_combine a flat sequence of non-negative ints.

    Vectorized: the combine recurrence is inherently sequential, but numpy
    uint64 arithmetic inside a C loop via np.frompyfunc is still far too
    slow for raster planes, so we chunk through a Python loop over a numpy
    array (fast enough for test/tooling use; the C++ fast path in
    alfalfa_tpu_torch/native covers production hashing).
    """
    arr = np.asarray(values).reshape(-1)
    if np.issubdtype(arr.dtype, np.signedinteger):
        # match C++ static_cast<size_t>: sign-extend to 64 bits, then wrap
        arr = arr.astype(np.int64)
    try:
        from alfalfa_tpu_torch.native import bitwork
        return bitwork.hash_range(seed, arr.astype(np.uint64, copy=False))
    except Exception:
        if arr.size > 1 << 16:
            import warnings
            warnings.warn(
                "native bitwork unavailable: hashing %d elements in a "
                "Python loop (seconds per 720p raster); check the g++ "
                "toolchain" % arr.size, RuntimeWarning, stacklevel=2)
    for v in arr.astype(np.uint64, copy=False).tolist():
        seed = hash_combine(seed, v)
    return seed


def raster_hash(y, u, v):
    """Hash of a full padded YUV raster (reference util/raster.cc:52-60)."""
    seed = hash_range(0, y)
    seed = hash_range(seed, u)
    return hash_range(seed, v)


def decoder_hash(state_hash, last_hash, golden_hash, alt_hash):
    seed = hash_combine(0, state_hash)
    seed = hash_combine(seed, last_hash)
    seed = hash_combine(seed, golden_hash)
    return hash_combine(seed, alt_hash)


def minihash(full_hash):
    return full_hash & 0xFFFFFFFF
