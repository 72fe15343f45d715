"""YUV4MPEG2 (.y4m) reader/writer for C420 content.

Equivalent capability to the reference's input/yuv4mpeg.cc; rasters are
numpy arrays (Y: HxW, U/V: H/2 x W/2, uint8).
"""
import re

import numpy as np


class Y4MReader:
    def __init__(self, path):
        self.f = path if hasattr(path, "read") else open(path, "rb")
        header = self.f.readline().decode()
        if not header.startswith("YUV4MPEG2"):
            raise ValueError("not a YUV4MPEG2 file")
        self.width = self.height = None
        self.fps_numerator, self.fps_denominator = 30, 1
        for tag in header.split()[1:]:
            key, val = tag[0], tag[1:]
            if key == "W":
                self.width = int(val)
            elif key == "H":
                self.height = int(val)
            elif key == "F":
                m = re.match(r"(\d+):(\d+)", val)
                self.fps_numerator, self.fps_denominator = int(m.group(1)), int(m.group(2))
            elif key == "C" and not val.startswith("420"):
                raise ValueError(f"unsupported chroma mode C{val}")
        if self.width is None or self.height is None:
            raise ValueError("y4m missing dimensions")
        self._frame_bytes = self.width * self.height * 3 // 2
        self._data_start = self.f.tell()

    def read_frame(self):
        """Returns (y, u, v) or None at EOF."""
        line = self.f.readline()
        if not line:
            return None
        if not line.startswith(b"FRAME"):
            raise ValueError("invalid y4m frame header")
        raw = self.f.read(self._frame_bytes)
        if len(raw) != self._frame_bytes:
            raise ValueError("y4m truncated frame")
        w, h = self.width, self.height
        y = np.frombuffer(raw, np.uint8, w * h).reshape(h, w)
        u = np.frombuffer(raw, np.uint8, w * h // 4, w * h).reshape(h // 2, w // 2)
        v = np.frombuffer(raw, np.uint8, w * h // 4, w * h * 5 // 4).reshape(h // 2, w // 2)
        return y, u, v

    def __iter__(self):
        self.f.seek(self._data_start)
        while True:
            frame = self.read_frame()
            if frame is None:
                return
            yield frame

    def close(self):
        self.f.close()


class Y4MWriter:
    def __init__(self, path, width, height, fps_numerator=30, fps_denominator=1):
        self.f = open(path, "wb")
        self.f.write(b"YUV4MPEG2 W%d H%d F%d:%d Ip A1:1 C420\n"
                     % (width, height, fps_numerator, fps_denominator))

    def append_frame(self, y, u, v):
        self.f.write(b"FRAME\n")
        self.f.write(np.ascontiguousarray(y, np.uint8).tobytes())
        self.f.write(np.ascontiguousarray(u, np.uint8).tobytes())
        self.f.write(np.ascontiguousarray(v, np.uint8).tobytes())

    def close(self):
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
