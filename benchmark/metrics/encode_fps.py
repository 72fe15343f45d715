"""Frames whose final bytes the entry delivered in the window, over all of
its time (a chunk's frames count when the terminated chunk and its exit
state are out; a rebased frame when it is written)."""
UNIT = "frames/s"


def read(run):
    r = run.records
    return r["frames"] / r["window_s"] if r.get("window_s") else None
