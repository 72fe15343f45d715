"""Poller: poll(2)-style event loop with callback actions and
``when_interested`` guards (net/poller.hh:39-90, poller.cc).

Actions register a file-like object (anything with fileno()), a direction,
a callback returning a Result, and an optional interest guard evaluated
before each poll.
"""
import enum
import select


class Direction(enum.IntEnum):
    In = select.POLLIN
    Out = select.POLLOUT


class ResultType(enum.Enum):
    Success = 0
    Continue = 1
    Cancel = 2
    Exit = 3


class Result:
    def __init__(self, result=ResultType.Success, exit_status=0):
        self.result = result
        self.exit_status = exit_status


class Action:
    def __init__(self, fd, direction, callback, when_interested=None):
        self.fd = fd
        self.direction = direction
        self.callback = callback
        self.when_interested = when_interested or (lambda: True)
        self.active = True


class PollResult:
    class Type(enum.Enum):
        Success = 0
        Timeout = 1
        Exit = 2

    def __init__(self, result, exit_status=0):
        self.result = result
        self.exit_status = exit_status


class Poller:
    def __init__(self):
        self._actions = []

    def add_action(self, action):
        self._actions.append(action)

    def poll(self, timeout_ms):
        poller = select.poll()
        fd_map = {}
        for a in self._actions:
            if not a.active or not a.when_interested():
                continue
            fd = a.fd.fileno()
            fd_map.setdefault(fd, 0)
            fd_map[fd] |= int(a.direction)
        if not fd_map:
            return PollResult(PollResult.Type.Timeout)
        for fd, mask in fd_map.items():
            poller.register(fd, mask)

        events = dict(poller.poll(timeout_ms if timeout_ms >= 0 else None))
        if not events:
            return PollResult(PollResult.Type.Timeout)

        for a in list(self._actions):
            if not a.active or not a.when_interested():
                continue
            fd = a.fd.fileno()
            revents = events.get(fd, 0)
            if revents & (select.POLLERR | select.POLLHUP | select.POLLNVAL):
                return PollResult(PollResult.Type.Exit, 1)
            if revents & int(a.direction):
                res = a.callback()
                if isinstance(res, ResultType):
                    res = Result(res)
                if res.result == ResultType.Exit:
                    return PollResult(PollResult.Type.Exit, res.exit_status)
                if res.result == ResultType.Cancel:
                    a.active = False
        return PollResult(PollResult.Type.Success)
