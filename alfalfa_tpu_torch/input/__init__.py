"""Frame sources (reference src/input/): an abstract FrameInput plus
y4m / IVF / V4L2-camera / JPEG implementations.

Frames are (y, u, v) uint8 numpy planes in C420 layout.
"""
from .frame_input import FrameInput
from .yuv4mpeg import YUV4MPEGInput
from .ivf_input import IVFInput

__all__ = ["FrameInput", "YUV4MPEGInput", "IVFInput", "Camera",
           "JPEGDecompresser"]


def __getattr__(name):
    # Camera needs /dev/video* + V4L2 ioctls; JPEG needs an imaging lib.
    # Import lazily so headless/test environments never pay for them.
    if name == "Camera":
        from .camera import Camera
        return Camera
    if name == "JPEGDecompresser":
        from .jpeg import JPEGDecompresser
        return JPEGDecompresser
    raise AttributeError(name)
