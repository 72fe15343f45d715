"""The benchmark's general part: finding a cell's files by name, the run's
set-up / window / check sequence, the device trace's reduction, and the
result line.  Drivers, traffic, configurations and metrics are data and
small modules under this folder; nothing here names one of them.
"""
import contextlib
import gc
import importlib.util
import json
import os
import re
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "alfalfa_tpu")
# build and kernel caches at fixed paths inside the checkout (the port
# keeps its own CUDA and host libraries in its package directory)
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": os.path.join(".bench_cache", "torch_extensions"),
              "TRITON_CACHE_DIR": os.path.join(".bench_cache", "triton")}


def load_json(kind, name, bench=BENCH):
    with open(os.path.join(bench, kind, name + ".json")) as f:
        return json.load(f)


def load_module(kind, name, bench=BENCH):
    """``<bench>/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(bench, kind, name + ".py")
    mod_name = "benchmark_%s_%s" % (kind, "".join(
        ch if ch.isalnum() else "_" for ch in name))
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(name, bench=BENCH):
    """(workload, configuration) of the cell ``name``."""
    wl = load_json("workloads", name, bench)
    return wl, load_json("configs", wl["config"], bench)


def forbidden_modules():
    """Top-level names of loaded modules that the run must not load,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Run:
    """What the metric readers read: the window's records, and in a
    traced run the program's spans, device seconds by kernel name, the
    device's busy seconds and the traced window's length."""

    def __init__(self, workload, config):
        self.workload, self.config = workload, config
        self.records = {}
        self.spans = {}
        self.kernels = {}
        self.busy_s = None
        self.window_s = None
        self.counts = {}

    def span(self, name):
        s = self.spans.get(name)
        return (s["seconds"], s["count"]) if s else (0.0, 0)

    def kernel_seconds(self, names):
        """(calls, device seconds) of the kernels whose symbol is one of
        ``names`` (the trace's name may carry a return type, template
        arguments and parameters around it)."""
        pat = re.compile(r"(?<![\w:])(%s)(?=[<(])" % "|".join(map(re.escape, names)))
        calls, secs = 0, 0.0
        for k, (n, s) in self.kernels.items():
            if pat.search(k):
                calls += n
                secs += s
        return calls, secs


# ------------------------------------------------------------ tracing

@contextlib.contextmanager
def _annotated_stages():
    """While tracing, the program's stages are switched on, and each also
    records its interval on the host clock, from whatever thread opens
    it, so that the device trace can say what the host was doing in an
    idle gap.  Yields (the tracing module or None, the interval list)."""
    ranges = []
    try:
        from alfalfa_tpu_torch.util import tracing
    except ImportError:
        yield None, ranges
        return
    orig = tracing.stage

    @contextlib.contextmanager
    def stage(name, sync=False):
        t0 = time.perf_counter_ns()
        try:
            with orig(name, sync):
                yield
        finally:
            ranges.append((t0, time.perf_counter_ns(), name))

    tracing.stage = stage
    tracing.enable(True)
    tracing.snapshot(reset=True)
    try:
        yield tracing, ranges
    finally:
        tracing.enable(False)
        tracing.stage = orig


def _events(prof):
    """Device intervals (start ns, end ns, name) and the profiler's own
    ``bench:`` ranges, on the profiler's clock."""
    from torch.autograd import DeviceType
    dev, ann = [], []
    results = getattr(prof.profiler, "kineto_results", None)
    if results is not None:
        events = [(e.start_ns(), e.end_ns(), e.name(), e.device_type())
                  for e in results.events()]
    else:
        events = [(int(e.time_range.start * 1000), int(e.time_range.end * 1000),
                   e.name, e.device_type) for e in prof.events()]
    for s, t, name, kind in events:
        if name.startswith("bench:"):
            # a range opened on the host; the profiler also draws it on the
            # device's timeline around the kernels it launched
            if kind != DeviceType.CUDA:
                ann.append((s, t, name.split(":", 1)[1]))
        elif kind == DeviceType.CUDA:
            dev.append((s, t, name))
    return dev, ann


def reduce_trace(dev, ann, lo, hi):
    """Busy seconds (union of device intervals inside [lo, hi] ns), device
    seconds by name, the top device operations, and idle seconds summed by
    the innermost host range open at each gap's middle."""
    kernels = {}
    spans = []
    for s, t, name in dev:
        s, t = max(s, lo), min(t, hi)
        if t <= s:
            continue
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (t - s) / 1e9
        spans.append((s, t))
    spans.sort()
    merged = []
    for s, t in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged) / 1e9
    gaps, prev = [], lo
    for s, t in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if hi > prev:
        gaps.append((prev, hi))
    ann = sorted(ann)
    idle = {}
    for s, t in gaps:
        mid = (s + t) / 2
        inner = [a for a in ann if a[0] <= mid <= a[1]]
        name = max(inner)[2] if inner else "host (outside any span)"
        idle[name] = idle.get(name, 0.0) + (t - s) / 1e9
    top = lambda d: [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return busy, kernels, {"device_ops": top({k: v[1] for k, v in kernels.items()}),
                           "idle_gaps": top(idle)}


# ------------------------------------------------------------ the run

def run_cell(workload, seed, seconds, trace, t_start=None, device=None,
             bench=BENCH, out=sys.stdout, err=sys.stderr):
    """One run of ``workload``; returns the process exit code.  ``device``
    None: the CUDA card, and no run without one; a test may pass "cpu" to
    drive the program's plain path."""
    t_start = time.perf_counter() if t_start is None else t_start
    for key, rel in CACHE_DIRS.items():
        os.environ[key] = os.path.join(ROOT, rel)
    import torch
    wl, cfg = cell(workload, bench)
    chips = int(wl.get("chips", 1))
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print("no run: the cell asks for %d CUDA card(s), %d visible"
                  % (chips, torch.cuda.device_count()
                     if torch.cuda.is_available() else 0), file=err)
            return 2
        device = torch.device("cuda")
    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    driver = load_module("drivers", wl["driver"], bench).Driver(
        cfg, wl, seed, device, seconds)
    driver.setup()
    sync()
    # what set-up made stays alive through the window: out of the
    # collector's way, so that no full collection lands in the window
    gc.collect()
    gc.freeze()
    names = wl["per_layer"] if trace else wl["end_to_end"]
    readers = {n: load_module("metrics", n, bench) for n in names
               if n != "setup_s"}
    run = Run(wl, cfg)
    for r in readers.values():
        if trace and hasattr(r, "instrument"):
            r.instrument(run)
    breakdown = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with _annotated_stages() as (tracing, ranges), \
                torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            with torch.profiler.record_function("bench:window"):
                h0 = time.perf_counter_ns()
                run.records = driver.window(seconds)
                sync()
                h1 = time.perf_counter_ns()
            t1 = time.perf_counter()
        run.spans = tracing.snapshot() if tracing is not None else {}
        dev, ann = _events(prof)
        win = [a for a in ann if a[2] == "window"]
        lo, hi = (win[0][0], win[0][1]) if win else (h0, h1)
        # the stages' host-clock intervals onto the profiler's clock
        shift = lo - h0
        ranges = [(a + shift, b + shift, n) for a, b, n in ranges]
        run.busy_s, run.kernels, breakdown = reduce_trace(dev, ranges, lo, hi)
        run.window_s = (hi - lo) / 1e9
        del prof
    else:
        t0 = time.perf_counter()
        run.records = driver.window(seconds)
        sync()
        t1 = time.perf_counter()
    setup_s = t0 - t_start

    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    metrics = {}
    for name in names:
        if name == "setup_s":
            metrics[name] = {"value": setup_s, "unit": "s"}
            continue
        value = readers[name].read(run)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": readers[name].UNIT}
            for k, v in (run.counts.get(name, {}).get("labels") or {}).items():
                metrics[name][k] = v

    driver.release()
    t_check = time.perf_counter()
    checks = driver.check()
    print("set-up %.3f s, window %.3f s, reference check %.3f s"
          % (setup_s, t1 - t0, time.perf_counter() - t_check), file=err)
    correct = bool(checks) and all(v <= lim for _, v, lim in checks)
    found = forbidden_modules()
    if found:
        print("no result: the run loaded %s" % ", ".join(found), file=err)
        return 3
    result = {
        "correct": correct,
        "attempted": int(run.records.get("attempted", 0)),
        "failed": int(run.records.get("failed", 0)),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else device.type,
            "kind": torch.cuda.get_device_name(device) if cuda else device.type,
            "count": chips if cuda else 0,
            "memory_peak_bytes": int(peak),
        },
    }
    if trace:
        result["device"]["busy_s"] = run.busy_s
        result["device"]["window_s"] = run.window_s
        result["breakdown"] = breakdown
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    for n, v, lim in checks:
        print("check %s %r limit %r %s" % (n, v, lim, "ok" if v <= lim else "FAILED"),
              file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0
