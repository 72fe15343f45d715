"""Trace-driven network emulation for Salsify testing.

The reference exercises its rate adaptation inside mahimahi shells with
cellular packet-delivery traces (the reference's scripts/run-contest:37-56,
mm-delay + mm-link with Verizon LTE traces).  This module reproduces that
harness in-process: an EmulatedLink is a UDP relay whose downlink forwards
queued datagrams only at trace-scheduled delivery opportunities (mahimahi
trace format: one millisecond timestamp per line, one ~MTU-sized
opportunity each, looping), after a fixed propagation delay, with a
drop-tail queue.  The reverse (ACK) path applies the propagation delay
only.

Usage:
    link = EmulatedLink(listen_port, dest_port, trace_ms=[...], delay_ms=20)
    link.start()
    # sender transmits to link.listen_port; receiver binds dest_port;
    # ACKs come back through the same relay.
"""
import heapq
import socket
import threading
import time
from collections import deque

MTU = 1500


def lte_like_trace(ms_total=16000, period_ms=4000, high_pps=24, low_pps=4):
    """Synthetic cellular-like delivery schedule: alternating windows of
    high and low capacity (high_pps/low_pps delivery opportunities per
    100 ms block), shaped like the varying-rate LTE traces the reference
    contest uses."""
    trace = []
    for block in range(ms_total // 100):
        t0 = block * 100
        high = (t0 % period_ms) < period_ms // 2
        n = high_pps if high else low_pps
        for k in range(n):
            trace.append(t0 + (k * 100) // n)
    return trace


def load_mahimahi_trace(path):
    """Parse a mahimahi packet-delivery trace (one ms-timestamp per line)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(int(line))
    return out


class _DelayLine:
    """Single-thread scheduled transmitter: (due_time, seq, data, addr)."""

    def __init__(self, send_fn):
        self._send = send_fn
        self._heap = []
        self._seq = 0
        self._cv = threading.Condition()
        self._stop = False
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def post(self, due, data, addr):
        with self._cv:
            heapq.heappush(self._heap, (due, self._seq, data, addr))
            self._seq += 1
            self._cv.notify()

    def _run(self):
        while True:
            with self._cv:
                while not self._stop and (
                        not self._heap
                        or self._heap[0][0] > time.monotonic()):
                    if self._heap:
                        self._cv.wait(max(
                            0.0, min(self._heap[0][0] - time.monotonic(),
                                     0.05)))
                    else:
                        self._cv.wait(0.05)
                if self._stop:
                    return
                _, _, data, addr = heapq.heappop(self._heap)
            self._send(data, addr)

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify()
        self.thread.join(timeout=1)


class EmulatedLink:
    """In-process bidirectional UDP relay with a trace-shaped downlink.

    Forward path (sender -> receiver): datagrams queue (drop-tail at
    queue_limit) and are released one per delivery opportunity, each
    opportunity carrying up to MTU bytes; release time additionally
    includes delay_ms of propagation.  Reverse path: delay only.
    """

    def __init__(self, listen_port, dest_port, trace_ms, delay_ms=20,
                 queue_limit=64, dest_host="127.0.0.1"):
        self.trace = sorted(trace_ms)
        if not self.trace:
            raise ValueError("empty trace")
        self.period = max(self.trace[-1] + 1, 1)
        self.delay = delay_ms / 1000.0
        self.queue_limit = queue_limit
        self.dest = (dest_host, dest_port)

        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", listen_port))
        self.sock.settimeout(0.05)
        self.listen_port = self.sock.getsockname()[1]

        self._queue = deque()
        self._sender_addr = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = []
        self._delay_line = None
        self.stats = {"delivered": 0, "dropped": 0, "acks": 0}

    # -- threads ----------------------------------------------------------

    def _rx_loop(self):
        """Receives from both directions on the relay socket; queues
        sender->receiver data, forwards receiver->sender ACKs after the
        propagation delay."""
        while not self._stop.is_set():
            try:
                data, addr = self.sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            if addr[1] == self.dest[1]:
                # reverse path (ACK): deliver to sender after delay
                with self._lock:
                    sender = self._sender_addr
                if sender is not None:
                    self._delay_line.post(time.monotonic() + self.delay,
                                          data, sender)
                    self.stats["acks"] += 1
            else:
                with self._lock:
                    self._sender_addr = addr
                    if len(self._queue) >= self.queue_limit:
                        self.stats["dropped"] += 1
                    else:
                        self._queue.append(data)

    def _send_safe(self, data, addr):
        try:
            self.sock.sendto(data, addr)
        except OSError:
            pass

    def _delivery_loop(self):
        """Walks the trace in real time; at each opportunity forwards up to
        MTU bytes worth of queued datagrams."""
        t_start = time.monotonic()
        i = 0
        epoch = 0
        while not self._stop.is_set():
            target = epoch * self.period / 1000.0 + self.trace[i] / 1000.0
            now = time.monotonic() - t_start
            if target > now:
                if self._stop.wait(min(target - now, 0.05)):
                    break
                continue
            budget = MTU
            while budget > 0:
                with self._lock:
                    if not self._queue or len(self._queue[0]) > budget:
                        break
                    data = self._queue.popleft()
                budget -= len(data)
                self._delay_line.post(time.monotonic() + self.delay,
                                      data, self.dest)
                self.stats["delivered"] += 1
            i += 1
            if i >= len(self.trace):
                i = 0
                epoch += 1

    # -- lifecycle --------------------------------------------------------

    def start(self):
        self._delay_line = _DelayLine(self._send_safe)
        for fn in (self._rx_loop, self._delivery_loop):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def close(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=1)
        if self._delay_line is not None:
            self._delay_line.close()
        self.sock.close()
