"""alfalfa_tpu_torch: the PyTorch/CUDA port of the VP8 codec framework.

Same layering and module names as the JAX package beside it, PyTorch's
idiom inside.  Host layers (bit-serial parse, codec state) are numpy and
C++; the pixel pipeline is torch tensors, with the two sequentially
dependent stages of decode written as CUDA kernels:

- ``util``       IVF container, stage timing
- ``bitstream``  VP8 entropy layer: bool coder, trees, spec tables, headers
- ``state``      DecoderState / Raster + hashing
- ``native``     C++ frame-header, MB-header and token parsers (ctypes)
- ``decoder``    frame parsing (host) + batched reconstruction (device)
- ``ops``        transforms, prediction, loop filter; the sixtap-MC and
                 decode-wavefront kernels with their plain versions
- ``csrc``       CUDA sources of those kernels
- ``parallel``   BatchedGopDecoder: G GOPs decoded in lockstep
- ``convert``    codec state and references carried between the packages

Every device entry point takes ``device=`` and defaults to CUDA.
"""

__version__ = "0.1.0"
