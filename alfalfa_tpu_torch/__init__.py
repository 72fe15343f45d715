"""alfalfa_tpu_torch: the PyTorch/CUDA port of the VP8 codec framework.

Same layering and module names as the JAX package beside it, PyTorch's
idiom inside.  Host layers (bit-serial parse, codec state) are numpy and
C++; the pixel pipeline is torch tensors, with the sequentially dependent
stages of decode and of key-frame encode written as CUDA kernels:

- ``util``       IVF container, y4m files, stage timing
- ``bitstream``  VP8 entropy layer: bool coder, trees, spec tables, headers
- ``state``      DecoderState / Raster + hashing; ``serdes``: .state files,
                 byte-identical to the JAX package's
- ``native``     C++ frame-header, MB-header and token parsers, and the
                 serializer's token and mode-header writers (ctypes)
- ``decoder``    frame parsing (host), reconstruction (device), and the
                 single-frame ``Decoder`` / ``FramePlayer`` / ``FilePlayer``
- ``encoder``    the ``Encoder`` (key frames on the device, interframes not
                 yet), its cost and trellis tables and the serializer
- ``ops``        transforms, prediction, loop filter, and the wrappers of
                 the CUDA kernels with their plain versions:
                 ``sixtap_cuda`` (the three planes' motion compensation
                 in one launch: ``mc_tiles`` for G frames,
                 ``predict_mb_tiles`` for one), ``wavefront_cuda``
                 (intra prediction + loop filter of G frames),
                 ``intra_cuda`` (intra prediction alone), ``lf_cuda`` (loop
                 filter alone), ``enc_intra_cuda`` (the key-frame encoder's
                 macroblock loop, with transforms and trellis)
- ``csrc``       CUDA sources of those kernels
- ``parallel``   BatchedGopDecoder: G GOPs decoded in lockstep; the
                 packed, pinned host-to-device upload the decoders share
- ``cli``        ``python -m alfalfa_tpu_torch.cli.xc decode|decode-raw``
- ``convert``    codec state, rasters and whole decoders and encoders
                 carried between the packages

Every device entry point takes ``device=`` and defaults to CUDA.
"""

__version__ = "0.1.0"
