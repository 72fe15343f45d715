"""What the per-layer metric files share: a span's mean in ms, a kernel's
share of its roofline, the device's idle share."""
from benchmark.bounds import kernels as bounds


def span_ms(run, names, per=None):
    """Seconds under the spans ``names`` summed, in ms per ``per`` (the
    first span's count when None); None when no span was recorded."""
    secs = sum(run.span(n)[0] for n in names)
    count = run.span(names[0])[1] if per is None else per
    if not count or not secs:
        return None
    return secs / count * 1e3


def roofline(run, name, kernel_names, bytes_per_call, ops_per_call=0):
    """100 x (the least time of every call) / (the calls' device time);
    None when the trace holds no such kernel."""
    calls, secs = run.kernel_seconds(kernel_names)
    if not calls or not secs:
        return None
    least, by = bounds.least_time(bytes_per_call, ops_per_call)
    run.counts[name] = {"labels": {"bound_by": by, "calls": calls}}
    return 100.0 * calls * least / secs


def idle(run):
    if not run.window_s or run.busy_s is None:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)


def geometry(run):
    g = run.records.get("geometry", {})
    return g.get("G", 1), g.get("R", 0), g.get("C", 0), g.get("Q", 1)
