"""Pacer: schedule outgoing packets with an inter-send delay
(net/pacer.hh:36-76)."""
import collections
import time


class Pacer:
    def __init__(self):
        self._queue = collections.deque()  # (due_time_s, payload_bytes)

    def ms_until_due(self):
        if not self._queue:
            return 1000  # finite so bugs surface within a second
        return max(0, int((self._queue[0][0] - time.monotonic()) * 1000))

    def empty(self):
        return not self._queue

    def push(self, payload, delay_microseconds):
        if not self._queue:
            self._queue.append((time.monotonic(), payload))
        else:
            self._queue.append((self._queue[-1][0] + delay_microseconds * 1e-6,
                                payload))

    def front(self):
        return self._queue[0][1]

    def pop(self):
        self._queue.popleft()

    def __len__(self):
        return len(self._queue)
