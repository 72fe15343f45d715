"""Camera: V4L2 mmap capture -> YUV420 planes (input/camera.cc:116-207).

Supported pixel formats mirror the reference: NV12, YUYV, YU12 (I420), and
MJPG via JPEGDecompresser.  The V4L2 backend talks to the kernel directly
(ioctl + mmap); a cv2 backend is available as a fallback for devices/formats
V4L2 user pointers don't cover.
"""
import ctypes
import fcntl
import mmap
import os
import select
import struct

import numpy as np

from .frame_input import FrameInput

# v4l2 ABI (linux/videodev2.h) — fourccs and ioctl numbers
def _fourcc(a, b, c, d):
    return ord(a) | (ord(b) << 8) | (ord(c) << 16) | (ord(d) << 24)


V4L2_PIX_FMT_NV12 = _fourcc('N', 'V', '1', '2')
V4L2_PIX_FMT_YUYV = _fourcc('Y', 'U', 'Y', 'V')
V4L2_PIX_FMT_YU12 = _fourcc('Y', 'U', '1', '2')
V4L2_PIX_FMT_MJPEG = _fourcc('M', 'J', 'P', 'G')

PIXEL_FORMATS = {"NV12": V4L2_PIX_FMT_NV12, "YUYV": V4L2_PIX_FMT_YUYV,
                 "YU12": V4L2_PIX_FMT_YU12, "MJPG": V4L2_PIX_FMT_MJPEG}

V4L2_BUF_TYPE_VIDEO_CAPTURE = 1
V4L2_MEMORY_MMAP = 1
V4L2_FIELD_NONE = 1

VIDIOC_S_FMT = 0xc0d05605
VIDIOC_REQBUFS = 0xc0145608
VIDIOC_QUERYBUF = 0xc0585609
VIDIOC_QBUF = 0xc058560f
VIDIOC_DQBUF = 0xc0585611
VIDIOC_STREAMON = 0x40045612
VIDIOC_STREAMOFF = 0x40045613


class _v4l2_format(ctypes.Structure):
    _fields_ = [("type", ctypes.c_uint32),
                ("width", ctypes.c_uint32),
                ("height", ctypes.c_uint32),
                ("pixelformat", ctypes.c_uint32),
                ("field", ctypes.c_uint32),
                ("bytesperline", ctypes.c_uint32),
                ("sizeimage", ctypes.c_uint32),
                ("colorspace", ctypes.c_uint32),
                ("priv", ctypes.c_uint32),
                ("flags", ctypes.c_uint32),
                ("enc", ctypes.c_uint32),
                ("quantization", ctypes.c_uint32),
                ("xfer_func", ctypes.c_uint32),
                ("pad", ctypes.c_uint8 * 160)]


class _v4l2_requestbuffers(ctypes.Structure):
    _fields_ = [("count", ctypes.c_uint32),
                ("type", ctypes.c_uint32),
                ("memory", ctypes.c_uint32),
                ("capabilities", ctypes.c_uint32),
                ("flags", ctypes.c_uint8),
                ("reserved", ctypes.c_uint8 * 3)]


class _v4l2_buffer(ctypes.Structure):
    class _timeval(ctypes.Structure):
        _fields_ = [("tv_sec", ctypes.c_long), ("tv_usec", ctypes.c_long)]

    class _timecode(ctypes.Structure):
        _fields_ = [("type", ctypes.c_uint32), ("flags", ctypes.c_uint32),
                    ("frames", ctypes.c_uint8), ("seconds", ctypes.c_uint8),
                    ("minutes", ctypes.c_uint8), ("hours", ctypes.c_uint8),
                    ("userbits", ctypes.c_uint8 * 4)]

    class _m(ctypes.Union):
        _fields_ = [("offset", ctypes.c_uint32), ("userptr", ctypes.c_ulong),
                    ("planes", ctypes.c_void_p), ("fd", ctypes.c_int32)]

    _fields_ = [("index", ctypes.c_uint32), ("type", ctypes.c_uint32),
                ("bytesused", ctypes.c_uint32), ("flags", ctypes.c_uint32),
                ("field", ctypes.c_uint32), ("timestamp", _timeval),
                ("timecode", _timecode), ("sequence", ctypes.c_uint32),
                ("memory", ctypes.c_uint32), ("m", _m),
                ("length", ctypes.c_uint32), ("reserved2", ctypes.c_uint32),
                ("reserved", ctypes.c_uint32)]


NUM_BUFFERS = 4  # camera.cc buffer count


class Camera(FrameInput):
    def __init__(self, device="/dev/video0", width=1280, height=720,
                 pixel_format="NV12", backend="v4l2"):
        self.width, self.height = width, height
        self.pixel_format = pixel_format
        self.backend = backend
        if backend == "cv2":
            self._init_cv2(device)
        else:
            self._init_v4l2(device, pixel_format)

    # -- v4l2 backend ----------------------------------------------------------

    def _init_v4l2(self, device, pixel_format):
        if pixel_format not in PIXEL_FORMATS:
            raise ValueError(f"unsupported pixel format {pixel_format}")
        self.fd = os.open(device, os.O_RDWR)
        fmt = _v4l2_format()
        fmt.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
        fmt.width, fmt.height = self.width, self.height
        fmt.pixelformat = PIXEL_FORMATS[pixel_format]
        fmt.field = V4L2_FIELD_NONE
        fcntl.ioctl(self.fd, VIDIOC_S_FMT, fmt)
        if (fmt.width, fmt.height) != (self.width, self.height):
            raise RuntimeError(
                f"device gave {fmt.width}x{fmt.height}, wanted "
                f"{self.width}x{self.height}")

        req = _v4l2_requestbuffers()
        req.count = NUM_BUFFERS
        req.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
        req.memory = V4L2_MEMORY_MMAP
        fcntl.ioctl(self.fd, VIDIOC_REQBUFS, req)

        self.buffers = []
        for i in range(req.count):
            buf = _v4l2_buffer()
            buf.index = i
            buf.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
            buf.memory = V4L2_MEMORY_MMAP
            fcntl.ioctl(self.fd, VIDIOC_QUERYBUF, buf)
            m = mmap.mmap(self.fd, buf.length, offset=buf.m.offset)
            self.buffers.append(m)
            fcntl.ioctl(self.fd, VIDIOC_QBUF, buf)

        fcntl.ioctl(self.fd, VIDIOC_STREAMON,
                    struct.pack("i", V4L2_BUF_TYPE_VIDEO_CAPTURE))
        if pixel_format == "MJPG":
            from .jpeg import JPEGDecompresser
            self.jpeg = JPEGDecompresser()

    def _init_cv2(self, device):
        import cv2
        idx = device
        if isinstance(device, str) and device.startswith("/dev/video"):
            idx = int(device[len("/dev/video"):])
        self.cap = cv2.VideoCapture(idx)
        self.cap.set(cv2.CAP_PROP_FRAME_WIDTH, self.width)
        self.cap.set(cv2.CAP_PROP_FRAME_HEIGHT, self.height)

    def fileno(self):
        return self.fd

    def get_next_frame(self):
        if self.backend == "cv2":
            import cv2
            ok, bgr = self.cap.read()
            if not ok:
                return None
            i420 = cv2.cvtColor(bgr, cv2.COLOR_BGR2YUV_I420)
            return self._split_i420(i420.reshape(-1))

        select.select([self.fd], [], [])
        buf = _v4l2_buffer()
        buf.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
        buf.memory = V4L2_MEMORY_MMAP
        fcntl.ioctl(self.fd, VIDIOC_DQBUF, buf)
        data = np.frombuffer(self.buffers[buf.index],
                             np.uint8, buf.bytesused)
        frame = self._convert(data)
        fcntl.ioctl(self.fd, VIDIOC_QBUF, buf)
        return frame

    def _convert(self, data):
        w, h = self.width, self.height
        if self.pixel_format == "YU12":
            return self._split_i420(data)
        if self.pixel_format == "NV12":
            y = data[:w * h].reshape(h, w).copy()
            uv = data[w * h:w * h * 3 // 2].reshape(h // 2, w)
            return y, uv[:, 0::2].copy(), uv[:, 1::2].copy()
        if self.pixel_format == "YUYV":
            px = data[:w * h * 2].reshape(h, w, 2)
            y = px[:, :, 0].copy()
            u_full = px[:, 0::2, 1]
            v_full = px[:, 1::2, 1]
            # vertical 2:1 chroma subsample by averaging line pairs
            # (the reference averages the two source rows; camera.cc:168-189)
            u = ((u_full[0::2].astype(np.uint16) + u_full[1::2]) // 2).astype(np.uint8)
            v = ((v_full[0::2].astype(np.uint16) + v_full[1::2]) // 2).astype(np.uint8)
            return y, u, v
        if self.pixel_format == "MJPG":
            return self.jpeg.decompress(data.tobytes())
        raise RuntimeError(f"unsupported pixel format {self.pixel_format}")

    def _split_i420(self, data):
        w, h = self.width, self.height
        y = data[:w * h].reshape(h, w).copy()
        u = data[w * h:w * h * 5 // 4].reshape(h // 2, w // 2).copy()
        v = data[w * h * 5 // 4:w * h * 3 // 2].reshape(h // 2, w // 2).copy()
        return y, u, v

    @property
    def display_width(self):
        return self.width

    @property
    def display_height(self):
        return self.height

    def close(self):
        if self.backend == "cv2":
            self.cap.release()
            return
        fcntl.ioctl(self.fd, VIDIOC_STREAMOFF,
                    struct.pack("i", V4L2_BUF_TYPE_VIDEO_CAPTURE))
        for m in self.buffers:
            m.close()
        os.close(self.fd)
