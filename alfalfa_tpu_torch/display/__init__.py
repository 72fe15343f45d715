"""VideoDisplay: on-screen YUV playback (reference src/display/display.cc).

The reference renders via an OpenGL YCbCr->RGB fragment shader; here the
conversion runs through OpenCV's I420 path and an HighGUI window.  Gated:
making a VideoDisplay on a host without ``cv2`` raises ImportError, and
OpenCV itself fails without a display.  A copy of the JAX package's
display/ (host code: planes are read through ``Raster.display()``).
"""
import numpy as np


class VideoDisplay:
    def __init__(self, width, height, fullscreen=False, title="alfalfa-tpu"):
        import cv2
        self.cv2 = cv2
        self.title = title
        flags = cv2.WINDOW_NORMAL if fullscreen else cv2.WINDOW_AUTOSIZE
        cv2.namedWindow(title, flags)
        if fullscreen:
            cv2.setWindowProperty(title, cv2.WND_PROP_FULLSCREEN,
                                  cv2.WINDOW_FULLSCREEN)

    def draw(self, raster):
        """raster: object with .display() -> (y, u, v), or a (y, u, v) tuple."""
        cv2 = self.cv2
        planes = raster.display() if hasattr(raster, "display") else raster
        y, u, v = planes
        i420 = np.concatenate([y.reshape(-1), u.reshape(-1), v.reshape(-1)])
        h, w = y.shape
        bgr = cv2.cvtColor(i420.reshape(h * 3 // 2, w), cv2.COLOR_YUV2BGR_I420)
        cv2.imshow(self.title, bgr)
        cv2.waitKey(1)

    def close(self):
        self.cv2.destroyWindow(self.title)
