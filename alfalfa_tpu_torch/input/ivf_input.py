"""IVFInput: decode an IVF into rasters as a FrameInput
(input/ivf_reader.hh:34-46 — the reference likewise wraps a decoder).
The frames are reconstructed on ``device`` (default CUDA) by the port's
``FilePlayer`` and handed out as numpy planes."""
from .frame_input import FrameInput


class IVFInput(FrameInput):
    def __init__(self, path, device=None):
        from alfalfa_tpu_torch.decoder import FilePlayer
        self.player = FilePlayer(path, device=device)

    def get_next_frame(self):
        while not self.player.eof():
            raster = self.player.advance()
            if raster is not None:
                return raster.display()
        return None

    @property
    def display_width(self):
        return self.player.width

    @property
    def display_height(self):
        return self.player.height
