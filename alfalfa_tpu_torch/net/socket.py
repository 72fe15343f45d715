"""UDPSocket: connected/bound UDP with kernel receive timestamps
(net/socket.hh:72-94; SO_TIMESTAMP at socket.hh:93).

The kernel RX timestamp feeds the receiver's inter-packet-delay EWMA, which
is the sender's only congestion signal — so we pull SCM_TIMESTAMP out of
recvmsg ancillary data rather than stamping in userspace.
"""
import socket
import struct
import time

# linux asm-generic SO_TIMESTAMP_OLD; the python module doesn't export it
SO_TIMESTAMP = getattr(socket, "SO_TIMESTAMP", 29)


class Datagram:
    __slots__ = ("payload", "source_address", "timestamp_us")

    def __init__(self, payload, source_address, timestamp_us):
        self.payload = payload
        self.source_address = source_address
        self.timestamp_us = timestamp_us


class UDPSocket:
    def __init__(self):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._connected = False

    def fileno(self):
        return self.sock.fileno()

    def bind(self, host, port):
        self.sock.bind((host, int(port)))

    def connect(self, host, port):
        self.sock.connect((host, int(port)))
        self._connected = True

    def set_timestamps(self):
        self.sock.setsockopt(socket.SOL_SOCKET, SO_TIMESTAMP, 1)

    def send(self, data):
        self.sock.send(data)

    def sendto(self, data, addr):
        self.sock.sendto(data, addr)

    def recv(self, bufsize=65536):
        """Receive one datagram; returns Datagram with the kernel RX
        timestamp when SO_TIMESTAMP is enabled, else a userspace stamp."""
        payload, ancdata, _flags, addr = self.sock.recvmsg(bufsize, 512)
        ts_us = None
        for level, ctype, data in ancdata:
            if level == socket.SOL_SOCKET and ctype == SO_TIMESTAMP \
                    and len(data) >= 16:
                sec, usec = struct.unpack_from("@qq", data, 0)
                ts_us = sec * 1_000_000 + usec
                break
        if ts_us is None:
            ts_us = int(time.time() * 1_000_000)
        return Datagram(payload, addr, ts_us)

    def setblocking(self, flag):
        self.sock.setblocking(flag)

    def close(self):
        self.sock.close()

    def getsockname(self):
        return self.sock.getsockname()
