"""Per-stage timing and the profiler hook of ``xc --timings`` and
``xc --profile DIR``.

Named stage accumulators cheap enough to leave in the hot path, switched
on with ``enable()`` and read with ``snapshot()`` or printed with
``report()``.  Device time by kernel comes from ``torch.profiler``:
``profile(DIR)`` writes a Chrome trace of what runs inside it.

CUDA launches are asynchronous: a host clock around a launch measures the
enqueue, not the work.  ``stage(name, sync=True)`` therefore calls
``torch.cuda.synchronize()`` before it reads the clock at entry and at exit
(only while tracing is enabled, and only when CUDA is initialised), so the
span covers the device work started inside it.  ``stage(name)`` without
``sync`` and ``add`` time the host side only (parse, packing, dispatch).
"""
import contextlib
import os
import sys
import time
from collections import defaultdict

_ENABLED = False
_acc = defaultdict(lambda: [0.0, 0])   # name -> [seconds, count]


def enable(flag=True):
    global _ENABLED
    _ENABLED = bool(flag)


def enabled():
    return _ENABLED


def _device_sync():
    import torch
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def stage(name, sync=False):
    """Accumulate wall time under ``name`` (no-op unless enabled).

    sync=True drains the CUDA device at entry and exit so the span holds
    the device work started inside it; without it the span is host time
    (for a stage that launches kernels: dispatch time only)."""
    if not _ENABLED:
        yield
        return
    if sync:
        _device_sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync:
            _device_sync()
        a = _acc[name]
        a[0] += time.perf_counter() - t0
        a[1] += 1


def add(name, seconds, count=1):
    """Add host-measured seconds under ``name`` (never synchronises)."""
    if _ENABLED:
        a = _acc[name]
        a[0] += seconds
        a[1] += count


def snapshot(reset=True):
    """Accumulated stages as {name: {"seconds": s, "count": n}}."""
    out = {k: {"seconds": v[0], "count": v[1]} for k, v in _acc.items()}
    if reset:
        _acc.clear()
    return out


def report():
    """Print the accumulated stages to stderr, longest first, and reset
    them."""
    if not _acc:
        return
    width = max(len(k) for k in _acc)
    print("-- stage timings --", file=sys.stderr)
    for name, (total, n) in sorted(_acc.items(), key=lambda kv: -kv[1][0]):
        per = total / n * 1000 if n else 0.0
        print(f"  {name:<{width}}  total {total * 1000:9.1f} ms   "
              f"n {n:5d}   mean {per:8.2f} ms", file=sys.stderr)
    _acc.clear()


@contextlib.contextmanager
def profile(trace_dir):
    """torch.profiler over the block (CPU activity, and CUDA where this
    build of torch can trace a device), written as a Chrome trace into
    ``trace_dir``; the file is named on stderr.  ``trace_dir`` None:
    nothing is traced."""
    if not trace_dir:
        yield
        return
    import torch
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "xc.%d.trace.json" % os.getpid())
    activities = torch.profiler.supported_activities()
    with torch.profiler.profile(activities=activities) as prof:
        yield
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}", file=sys.stderr)
