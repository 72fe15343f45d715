"""JPEGDecompresser: MJPEG frame -> YUV420 planes (input/jpeg.hh:41-63).

Uses OpenCV's libjpeg path when available (decode straight to I420),
falling back to PIL + a BT.601 conversion.
"""
import numpy as np


class JPEGDecompresser:
    def __init__(self):
        try:
            import cv2
            self._cv2 = cv2
        except ImportError:
            self._cv2 = None
            import PIL.Image  # noqa: F401 — fail fast if neither exists

    def decompress(self, jpeg_bytes):
        if self._cv2 is not None:
            cv2 = self._cv2
            bgr = cv2.imdecode(np.frombuffer(jpeg_bytes, np.uint8),
                               cv2.IMREAD_COLOR)
            if bgr is None:
                raise ValueError("bad JPEG frame")
            h, w = bgr.shape[:2]
            i420 = cv2.cvtColor(bgr, cv2.COLOR_BGR2YUV_I420).reshape(-1)
            y = i420[:w * h].reshape(h, w)
            u = i420[w * h:w * h * 5 // 4].reshape(h // 2, w // 2)
            v = i420[w * h * 5 // 4:].reshape(h // 2, w // 2)
            return y.copy(), u.copy(), v.copy()

        import PIL.Image
        import io
        img = PIL.Image.open(io.BytesIO(jpeg_bytes)).convert("RGB")
        rgb = np.asarray(img, np.float32)
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        y = 0.299 * r + 0.587 * g + 0.114 * b
        u_full = 128 - 0.168736 * r - 0.331264 * g + 0.5 * b
        v_full = 128 + 0.5 * r - 0.418688 * g - 0.081312 * b
        u = u_full.reshape(u_full.shape[0] // 2, 2, -1, 2).mean(axis=(1, 3))
        v = v_full.reshape(v_full.shape[0] // 2, 2, -1, 2).mean(axis=(1, 3))
        clip = lambda p: np.clip(np.round(p), 0, 255).astype(np.uint8)
        return clip(y), clip(u), clip(v)
