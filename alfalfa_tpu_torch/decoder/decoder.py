"""Decoder: explicit-state VP8 decoding, one frame at a time.

``Decoder`` carries (DecoderState, References) as values; decoding a frame
advances the state exactly like the reference (decoder.cc:83-159).  The
host parses the frame; the frame is reconstructed on ``device`` (default
CUDA) through ``reconstruct_torch.reconstruct``, and the reference rasters
stay there between frames.
"""
import torch

from alfalfa_tpu_torch.bitstream.header import UncompressedChunk
from alfalfa_tpu_torch.native import bitwork
from alfalfa_tpu_torch.parallel.upload import PinnedStaging
from alfalfa_tpu_torch.state.decoder_state import DecoderState, References
from alfalfa_tpu_torch.state import hashing
from alfalfa_tpu_torch.util import tracing
from .parse import FrameParser
from . import reconstruct_torch


class Decoder:
    def __init__(self, width, height, state=None, references=None,
                 device=None, error_concealment=False):
        self.device = torch.device("cuda" if device is None else device)
        with tracing.stage("decode.new"):
            self.state = (state if state is not None
                          else DecoderState.initial(width, height))
            refs = (references if references is not None
                    else References.create(width, height))
            self.references = refs.on_device(self.device)
            if self.device.type == "cuda":
                # the native parsers must load: the Python parsers they
                # would fall back to are minutes per 720p frame
                bitwork._load()
                bitwork._load_mb()
        self.error_concealment = error_concealment
        # the pinned buffers each frame's upload goes through, shared with
        # this decoder's copies
        self._staging = PinnedStaging(self.device)

    @property
    def width(self):
        return self.state.width

    @property
    def height(self):
        return self.state.height

    @torch.inference_mode()
    def decode_frame(self, payload):
        """Decode one compressed frame; returns (shown, Raster) and advances
        the decoder state and references.  The raster's planes are tensors
        on the decoder's device (inference tensors: read them, clone them,
        but do not write them in place)."""
        with tracing.stage("decode.frame"):
            chunk = UncompressedChunk(payload, self.width, self.height,
                                      accept_partial=self.error_concealment)
            # experimental (version 4/6) interframes decode like normal
            # interframes: the version bits are advisory
            with tracing.stage("decode.parse"):
                header, arrays, _ = FrameParser(self.state).parse(chunk)
            with tracing.stage("decode.reconstruct", sync=True):
                raster = reconstruct_torch.reconstruct(
                    header, arrays, self.state, self.references,
                    chunk.key_frame, device=self.device,
                    staging=self._staging)
            self._update_references(chunk.key_frame, header, raster)
        return chunk.show_frame, raster

    def _update_references(self, key_frame, header, raster):
        """Reference refresh/copy semantics (frame.cc:271-307)."""
        refs = self.references
        if key_frame:
            refs.last = refs.golden = refs.alternative = raster
            return
        if header.copy_buffer_to_alternate == 1:
            refs.alternative = refs.last
        elif header.copy_buffer_to_alternate == 2:
            refs.alternative = refs.golden
        if header.copy_buffer_to_golden == 1:
            refs.golden = refs.last
        elif header.copy_buffer_to_golden == 2:
            refs.golden = refs.alternative
        if header.refresh_golden_frame:
            refs.golden = raster
        if header.refresh_alternate_frame:
            refs.alternative = raster
        if header.refresh_last:
            refs.last = raster

    def copy(self):
        """Value copy (the Salsify receiver keeps a minihash-addressed map
        of past decoders, salsify-receiver.cc:210-216).  Rasters are shared:
        a frame's planes never change after it is made."""
        d = Decoder(self.width, self.height, state=self.state.copy(),
                    references=self.references.copy(), device=self.device,
                    error_concealment=self.error_concealment)
        d._staging = self._staging
        return d

    # -- state identity ------------------------------------------------------

    def get_hash(self):
        return (self.state.hash(), self.references.last.hash(),
                self.references.golden.hash(), self.references.alternative.hash())

    def minihash(self):
        return hashing.minihash(hashing.decoder_hash(*self.get_hash()))

    def minihash_match(self, other_minihash):
        return other_minihash == 0 or self.minihash() == other_minihash


class FramePlayer:
    """Decoder + dimensions; mirrors reference player.hh:40-70."""

    def __init__(self, width, height, device=None):
        self.width, self.height = width, height
        self.decoder = Decoder(width, height, device=device)

    def decode(self, payload):
        """Returns the raster if the frame is shown, else None."""
        shown, raster = self.decoder.decode_frame(payload)
        return raster if shown else None

    def set_error_concealment(self, flag):
        self.decoder.error_concealment = flag

    def current_decoder(self):
        return self.decoder

    def set_decoder(self, decoder):
        self.decoder = decoder


class FilePlayer(FramePlayer):
    """IVF file + frame cursor (player.hh:72-97)."""

    def __init__(self, path, device=None):
        from alfalfa_tpu_torch.util.ivf import IVFReader
        self.ivf = IVFReader(path)
        super().__init__(self.ivf.width, self.ivf.height, device=device)
        if not self.decoder.minihash_match(self.ivf.expected_decoder_minihash):
            raise ValueError("IVF expects decoder to start in different state")
        self.frame_no = 0

    def eof(self):
        return self.frame_no >= len(self.ivf)

    def advance(self):
        """Decode frames until one is shown; returns its raster."""
        while not self.eof():
            raster = self.decode(self.ivf.frame(self.frame_no))
            self.frame_no += 1
            if raster is not None:
                return raster
        raise EOFError("no more frames")

    def __iter__(self):
        while not self.eof():
            try:
                yield self.advance()
            except EOFError:
                return
