"""fake-webcam: pace a y4m file onto stdout at a fixed frame rate
(reference src/salsify/fake-webcam.cc), for feeding the sender or a
v4l2loopback device without real camera hardware.
"""
import sys
import time

from alfalfa_tpu_torch.input.frame_input import FrameInput
from alfalfa_tpu_torch.util.y4m import Y4MReader


class Y4MInput(FrameInput):
    """FrameInput over a y4m file, paced to a fixed frame rate (the
    in-process equivalent of fake-webcam piping into the sender)."""

    def __init__(self, path, fps=None, loop=False):
        self.reader = Y4MReader(path)
        self.frames = list(self.reader)
        self.i = 0
        self.loop = loop
        self.interval = (1.0 / fps) if fps else None
        self._next_due = time.monotonic()

    def get_next_frame(self):
        if self.i >= len(self.frames):
            if not self.loop or not self.frames:
                return None
            self.i = 0
        if self.interval is not None:
            now = time.monotonic()
            if self._next_due > now:
                time.sleep(self._next_due - now)
            self._next_due = max(self._next_due + self.interval, now)
        f = self.frames[self.i]
        self.i += 1
        return f

    @property
    def display_width(self):
        return self.reader.width

    @property
    def display_height(self):
        return self.reader.height


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print(f"Usage: fake-webcam INPUT FPS", file=sys.stderr)
        return 1
    reader = Y4MReader(argv[0])
    fps = int(argv[1])
    out = sys.stdout.buffer

    interval = 1.0 / fps
    next_due = time.monotonic()
    out.write(f"YUV4MPEG2 W{reader.width} H{reader.height} "
              f"F{fps}:1 Ip A1:1 C420\n".encode())
    for y, u, v in reader:
        now = time.monotonic()
        if next_due > now:
            time.sleep(next_due - now)
        next_due += interval
        out.write(b"FRAME\n")
        out.write(y.tobytes())
        out.write(u.tobytes())
        out.write(v.tobytes())
        out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
