"""YUV4MPEGInput: .y4m file as a FrameInput (input/yuv4mpeg.hh:68-90)."""
from alfalfa_tpu_torch.util.y4m import Y4MReader
from .frame_input import FrameInput


class YUV4MPEGInput(FrameInput):
    def __init__(self, path_or_file):
        self.reader = Y4MReader(path_or_file)

    def get_next_frame(self):
        return self.reader.read_frame()

    @property
    def display_width(self):
        return self.reader.width

    @property
    def display_height(self):
        return self.reader.height

    @property
    def fps(self):
        return self.reader.fps_numerator / max(1, self.reader.fps_denominator)
