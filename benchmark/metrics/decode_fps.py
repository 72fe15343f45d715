"""Frames decoded in the window, complete on the card, over all of the
window's time."""
UNIT = "frames/s"


def read(run):
    r = run.records
    return r["frames"] / r["window_s"] if r.get("window_s") else None
