"""One host-to-device copy per step: the decoders' upload format.

A dict of numpy arrays is packed into one uint8 buffer (``pack_upload``),
copied to the device in one non-blocking copy out of pinned memory
(``PinnedStaging``), and sliced back into typed views there
(``unpack_upload``).  The GOP decoder (parallel/gop.py) uploads each frame
position this way, the single-frame decoder (decoder/reconstruct_torch.py)
each frame: a copy has a fixed cost, so one is cheaper than one per array.
"""
import threading

import numpy as np
import torch

_ALIGN = 16     # byte alignment of every segment of the upload buffer

_TORCH_DTYPES = {"|u1": torch.uint8, "|i1": torch.int8, "<i2": torch.int16,
                 "<i4": torch.int32, "|b1": torch.bool}


def pack_upload(batch):
    """Flatten the parse-output dict into ONE uint8 buffer + a spec of
    (key, dtype, shape, offset, size) segments, so a step uploads a single
    buffer and slices the segments back out on the device.  Segments start
    on _ALIGN-byte boundaries so the device can reinterpret them in place."""
    parts = []
    spec = []
    off = 0
    for k in sorted(batch):
        v = batch[k]
        if v is None:
            continue
        a = np.ascontiguousarray(v)
        flat = a.view(np.uint8).reshape(-1)
        spec.append((k, a.dtype.str, a.shape, off, flat.size))
        parts.append(flat)
        pad = -flat.size % _ALIGN
        if pad:
            parts.append(np.zeros(pad, np.uint8))
        off += flat.size + pad
    return np.concatenate(parts), tuple(spec)


def unpack_upload(mega, spec):
    """Inverse of pack_upload on a uint8 tensor (any device): views into
    ``mega``, no copies."""
    out = {}
    for k, dstr, shape, off, size in spec:
        seg = mega[off:off + size]
        dt = _TORCH_DTYPES[dstr]
        if dt != torch.uint8:
            seg = seg.view(dt)
        out[k] = seg.reshape(shape)
    return out


class PinnedStaging:
    """Uploads of packed buffers to ``device``: on a card one non-blocking
    copy out of one of two pinned staging buffers, each with an event, so a
    buffer is not rewritten while its copy may still be in flight; on the
    CPU the buffer itself.  Decoders that share one (a decoder and its
    copies) may upload from several threads: the lock keeps a buffer to one
    upload at a time."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._buffers = [None, None]
        self._events = [None, None]
        self._slot = 0
        self._lock = threading.Lock()

    def upload(self, mega):
        """The uint8 numpy buffer ``mega`` as a uint8 tensor on the
        device."""
        if self.device.type != "cuda":
            return torch.from_numpy(mega)
        with self._lock:
            slot = self._slot
            self._slot ^= 1
            if self._events[slot] is not None:
                self._events[slot].synchronize()
            buf = self._buffers[slot]
            if buf is None or buf.numel() < mega.size:
                buf = torch.empty(max(mega.size, 1 << 20) * 5 // 4,
                                  dtype=torch.uint8, pin_memory=True)
                self._buffers[slot] = buf
            buf.numpy()[:mega.size] = mega
            dev = torch.empty(mega.size, dtype=torch.uint8,
                              device=self.device)
            dev.copy_(buf[:mega.size], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._events[slot] = ev
            return dev
