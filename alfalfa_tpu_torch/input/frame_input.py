"""FrameInput: the abstract frame source (input/frame_input.hh:35-42)."""
import abc


class FrameInput(abc.ABC):
    @abc.abstractmethod
    def get_next_frame(self):
        """Returns (y, u, v) uint8 planes, or None at end of stream."""

    @property
    @abc.abstractmethod
    def display_width(self):
        ...

    @property
    @abc.abstractmethod
    def display_height(self):
        ...

    def __iter__(self):
        while True:
            frame = self.get_next_frame()
            if frame is None:
                return
            yield frame
