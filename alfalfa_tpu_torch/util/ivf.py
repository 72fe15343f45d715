"""IVF (DKIF) container reader/writer.

Matches the reference's layout (util/ivf.cc, util/ivf_writer.cc), including
the ExCamera extension: bytes 28-31 of the 32-byte header, unused in stock
IVF, carry the *expected decoder entry state minihash* so that chunked
decoding can verify it resumes from the right state.
"""
import struct


HEADER_LEN = 32
FRAME_HEADER_LEN = 12
MAGIC = b"DKIF"
SUPPORTED_VERSION = 0


class IVFReader:
    def __init__(self, path_or_bytes):
        if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
            self.data = bytes(path_or_bytes)
        else:
            with open(path_or_bytes, "rb") as f:
                self.data = f.read()
        d = self.data
        if d[0:4] != MAGIC:
            raise ValueError("missing IVF magic number")
        (version, header_len) = struct.unpack_from("<HH", d, 4)
        if version != SUPPORTED_VERSION or header_len != HEADER_LEN:
            raise ValueError("unsupported IVF version/header length")
        self.fourcc = d[8:12].decode()
        (self.width, self.height, self.frame_rate, self.time_scale,
         self.frame_count) = struct.unpack_from("<HHIII", d, 12)
        (self.expected_decoder_minihash,) = struct.unpack_from("<I", d, 28)

        self._offsets = []  # (payload offset, payload size)
        pos = HEADER_LEN
        for _ in range(self.frame_count):
            if pos + FRAME_HEADER_LEN > len(d):
                raise ValueError("IVF truncated")
            (size,) = struct.unpack_from("<I", d, pos)
            self._offsets.append((pos + FRAME_HEADER_LEN, size))
            pos += FRAME_HEADER_LEN + size

    def __len__(self):
        return self.frame_count

    def frame(self, index):
        off, size = self._offsets[index]
        return self.data[off:off + size]

    def __iter__(self):
        for i in range(self.frame_count):
            yield self.frame(i)


class IVFWriter:
    def __init__(self, path, fourcc="VP80", width=0, height=0,
                 frame_rate=1, time_scale=1, expected_decoder_minihash=0):
        self.f = open(path, "wb")
        self.fourcc = fourcc.encode()
        self.width, self.height = width, height
        self.frame_rate, self.time_scale = frame_rate, time_scale
        self.frame_count = 0
        self.expected_decoder_minihash = expected_decoder_minihash
        self._write_header()

    def _write_header(self):
        self.f.seek(0)
        self.f.write(MAGIC)
        self.f.write(struct.pack("<HH", SUPPORTED_VERSION, HEADER_LEN))
        self.f.write(self.fourcc)
        self.f.write(struct.pack("<HHIII", self.width, self.height,
                                 self.frame_rate, self.time_scale,
                                 self.frame_count))
        self.f.write(struct.pack("<I", self.expected_decoder_minihash))

    def set_expected_minihash(self, minihash):
        self.expected_decoder_minihash = minihash & 0xFFFFFFFF
        pos = self.f.tell()
        self._write_header()
        self.f.seek(pos)

    def append_frame(self, payload, timestamp=None):
        if timestamp is None:
            timestamp = self.frame_count
        self.f.seek(0, 2)
        self.f.write(struct.pack("<IQ", len(payload), timestamp))
        self.f.write(payload)
        self.frame_count += 1
        pos = self.f.tell()
        self._write_header()
        self.f.seek(pos)

    def close(self):
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
