"""Per-stage timing, work counters and the profiler hook of ``xc --timings``
and ``xc --profile DIR``.

Named spans and counters cheap enough to leave in the hot path, switched
on with ``enable()`` and read with ``snapshot()`` or printed with
``report()``.  Device time by kernel comes from ``torch.profiler``:
``profile(DIR)`` writes a Chrome trace of what runs inside it, and inside
it every span also opens a ``torch.profiler.record_function`` range, so
the trace shows the codec's stages on the profiler's own clock beside the
kernels they launched.

Spans nest: each thread keeps a stack of the spans it has open, so a span's
parent is the span that was open on its thread when it began.  A span's
self time is its duration less what its children on the same thread
covered; ``add`` counts as a child of the span open on its thread.

CUDA launches are asynchronous: a host clock around a launch measures the
enqueue, not the work.  ``stage(name, sync=True)`` therefore calls
``torch.cuda.synchronize()`` before it reads the clock at entry and at exit
(only while tracing is enabled, and only when CUDA is initialised), so the
span covers the device work started inside it.  ``stage(name)`` without
``sync`` and ``add`` time the host side only (parse, packing, dispatch).

``count(name, n)`` sums work done (bytes copied, levels filtered); its
arguments are values the caller already holds, so a disabled call costs a
function call and a test of one flag.  A span and a counter never share a
name.
"""
import contextlib
import os
import sys
import threading
import time
from collections import defaultdict

_ENABLED = False
_PROFILING = False      # inside profile(): spans open record_function too
_lock = threading.Lock()
_acc = defaultdict(lambda: [0.0, 0, 0.0])   # span -> [seconds, count, self]
_counters = defaultdict(lambda: [0, 0])     # counter -> [count, value]
_local = threading.local()                  # .stack: open spans' child time
_NULL = contextlib.nullcontext()


def enable(flag=True):
    global _ENABLED
    _ENABLED = bool(flag)


def enabled():
    return _ENABLED


def _device_sync():
    import torch
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _stack():
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _record(name, seconds, self_seconds, count=1):
    """Book a closed span or an ``add`` under ``name``, and its seconds as
    child time of the span open on this thread."""
    stack = _stack()
    if stack:
        stack[-1] += seconds
    with _lock:
        a = _acc[name]
        a[0] += seconds
        a[1] += count
        a[2] += self_seconds


class _Span:
    __slots__ = ("name", "sync", "t0", "range")

    def __init__(self, name, sync):
        self.name, self.sync, self.range = name, sync, None

    def __enter__(self):
        if _PROFILING:
            import torch
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        if self.sync:
            _device_sync()
        _stack().append(0.0)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync:
            _device_sync()
        seconds = time.perf_counter() - self.t0
        _record(self.name, seconds, seconds - _stack().pop())
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def stage(name, sync=False):
    """A context manager that accumulates wall time under ``name`` (no-op
    unless enabled; inside ``profile()`` a profiler range whether enabled
    or not).

    sync=True drains the CUDA device at entry and exit so the span holds
    the device work started inside it; without it the span is host time
    (for a stage that launches kernels: dispatch time only)."""
    if _ENABLED:
        return _Span(name, sync)
    if _PROFILING:
        import torch
        return torch.profiler.record_function(name)
    return _NULL


def add(name, seconds, count=1):
    """Add host-measured seconds under ``name`` (never synchronises); they
    count as a child of the span open on this thread."""
    if _ENABLED:
        _record(name, seconds, seconds, count)


def count(name, n=1):
    """Add the integer ``n`` to the counter ``name`` (no-op unless
    enabled)."""
    if _ENABLED:
        with _lock:
            c = _counters[name]
            c[0] += 1
            c[1] += int(n)


def snapshot(reset=True):
    """Accumulated spans as {name: {"seconds": s, "self_seconds": t,
    "count": n}} and counters as {name: {"seconds": 0.0, "self_seconds":
    0.0, "count": increments, "value": sum}}."""
    with _lock:
        out = {k: {"seconds": v[0], "self_seconds": v[2], "count": v[1]}
               for k, v in _acc.items()}
        out.update((k, {"seconds": 0.0, "self_seconds": 0.0, "count": v[0],
                        "value": v[1]}) for k, v in _counters.items())
        if reset:
            _acc.clear()
            _counters.clear()
    return out


def report():
    """Print the accumulated spans to stderr, longest first, with their
    self time, then the counters, and reset them."""
    snap = snapshot()
    spans = {k: v for k, v in snap.items() if "value" not in v}
    counters = {k: v for k, v in snap.items() if "value" in v}
    if spans:
        width = max(len(k) for k in spans)
        print("-- stage timings --", file=sys.stderr)
        for name, s in sorted(spans.items(), key=lambda kv: -kv[1]["seconds"]):
            n = s["count"]
            per = s["seconds"] / n * 1000 if n else 0.0
            print(f"  {name:<{width}}  total {s['seconds'] * 1000:9.1f} ms   "
                  f"self {s['self_seconds'] * 1000:9.1f} ms   "
                  f"n {n:5d}   mean {per:8.2f} ms", file=sys.stderr)
    if counters:
        width = max(len(k) for k in counters)
        print("-- counters --", file=sys.stderr)
        for name, c in sorted(counters.items()):
            print(f"  {name:<{width}}  value {c['value']:14d}   "
                  f"n {c['count']:5d}", file=sys.stderr)


@contextlib.contextmanager
def profile(trace_dir):
    """torch.profiler over the block (CPU activity, and CUDA where this
    build of torch can trace a device), written as a Chrome trace into
    ``trace_dir``, with a range for every span opened inside it; the file
    is named on stderr.  ``trace_dir`` None: nothing is traced."""
    global _PROFILING
    if not trace_dir:
        yield
        return
    import torch
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "xc.%d.trace.json" % os.getpid())
    activities = torch.profiler.supported_activities()
    with torch.profiler.profile(activities=activities) as prof:
        _PROFILING = True
        try:
            yield
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
        finally:
            _PROFILING = False
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}", file=sys.stderr)
