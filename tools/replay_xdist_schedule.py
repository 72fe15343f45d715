#!/usr/bin/env python3
"""Replay pytest-xdist's ``--dist load`` schedule over a collection and a
junit file's test durations, to see how long the tier-1 command would take
with more or fewer test items, before running it.

    python tools/replay_xdist_schedule.py --junit /tmp/_t1.xml
    python tools/replay_xdist_schedule.py --junit /tmp/_t1.xml \\
        --scan 430:530 --vary tests/test_torch_rebase.py

The collection order comes from ``pytest --collect-only -q -m 'not slow'``
(or ``--collected FILE``, one node id a line).  The replay follows
xdist 3.8's ``LoadScheduling``: each of the W workers first gets
``N // W // 4`` consecutive items; a worker whose queue falls below
``max(2, pending // W // 4)`` is topped up to ``max(2, pending // W //
2)`` from the front of the pending list, unless its last test took 0.1 s
or more and it still has two queued.  A worker runs its queue in order.
Items missing from the junit file take ``--default`` seconds.  ``--scan``
replays other collection sizes by removing items of ``--vary`` (from its
start) or inserting default-length items after its last one.  It prints
the makespan (the slowest worker's seconds) and each worker's busy
seconds; worker crashes and start-up are not modelled.
"""
import argparse
import heapq
import subprocess
import sys
import xml.etree.ElementTree as ET


def durations(junit):
    out = {}
    for tc in ET.parse(junit).iter("testcase"):
        path = tc.get("classname").replace(".", "/") + ".py"
        out[path + "::" + tc.get("name")] = float(tc.get("time", 0))
    return out


def collected(path=None):
    if path:
        with open(path) as fh:
            return [l.strip() for l in fh if "::" in l]
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/", "-q", "-m", "not slow",
         "--collect-only", "-p", "no:cacheprovider", "-p", "no:randomly"],
        capture_output=True, text=True).stdout
    return [l.strip() for l in out.splitlines() if "::" in l]


def replay(times, workers):
    """(makespan, [busy seconds of each worker])."""
    n = len(times)
    pending = list(range(n))
    queue = {w: [] for w in range(workers)}
    chunk = max(n // workers // 4, 2)
    for w in range(workers):
        queue[w], pending = pending[:chunk], pending[chunk:]
    busy = [0.0] * workers
    events = [(times[queue[w][0]], w) for w in range(workers) if queue[w]]
    heapq.heapify(events)
    end = 0.0
    while events:
        now, w = heapq.heappop(events)
        done = queue[w].pop(0)
        busy[w] += times[done]
        end = max(end, now)
        if pending:
            lo = max(2, len(pending) // workers // 4)
            hi = max(2, len(pending) // workers // 2)
            waits = times[done] >= 0.1 and len(queue[w]) >= 2
            if len(queue[w]) < lo and not waits:
                k = hi - len(queue[w])
                queue[w] += pending[:k]
                pending = pending[k:]
        if queue[w]:
            heapq.heappush(events, (now + times[queue[w][0]], w))
    return end, busy


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--junit", required=True)
    ap.add_argument("--collected", default=None)
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--default", type=float, default=0.5)
    ap.add_argument("--scan", default=None, help="LO:HI collection sizes")
    ap.add_argument("--vary", default="tests/test_torch_rebase.py")
    args = ap.parse_args()
    dur = durations(args.junit)
    items = collected(args.collected)
    times = [dur.get(i, args.default) for i in items]
    end, busy = replay(times, args.workers)
    print("N %d: %.0f s; workers %s" % (len(items), end,
                                       [round(b) for b in busy]))
    if not args.scan:
        return
    pos = [k for k, i in enumerate(items) if i.startswith(args.vary)]
    lo, hi = (int(x) for x in args.scan.split(":"))
    for n in range(lo, hi + 1):
        t = list(times)
        delta = n - len(t)
        if delta < 0:
            for k in sorted(pos[:-delta], reverse=True):
                del t[k]
        else:
            t[pos[-1] + 1:pos[-1] + 1] = [args.default] * delta
        print("N %d (chunks of %d): %.0f s" % (n, n // args.workers // 4,
                                                replay(t, args.workers)[0]))


if __name__ == "__main__":
    main()
