"""What more than one driver needs: the cell's frames, ExCamera's chunk
encode, and the comparison of planes."""
import sys

import numpy as np

from benchmark.traffic import natural


def frames(config, traffic, seed, device, count=None):
    """The cell's camera frames, (y, u, v) uint8 numpy planes."""
    n = count if count is not None else (config["chunk_frames"]
                                         * config["chunks_per_string"])
    return natural.clip(traffic["content"], config["width"], config["height"],
                        n, seed, device)


def encode_chunks(frames, config, device):
    """ExCamera's phase 1 as ``xc-enc`` runs it on each chunk: a fresh
    encoder, a key frame, then interframes, all at the configuration's
    quantizer.  Returns one list of payloads a chunk."""
    from alfalfa_tpu_torch.encoder import Encoder
    n = config["chunk_frames"]
    out = []
    for s in range(0, len(frames), n):
        enc = Encoder(config["width"], config["height"],
                      quality=config["quality"],
                      two_pass=config.get("two_pass", False), device=device)
        out.append([bytes(enc.encode_with_quantizer(f, config["y_ac_qi"]))
                    for f in frames[s:s + n]])
    return out


def host(planes):
    """(y, u, v) of tensors or arrays as numpy arrays."""
    return tuple(p.cpu().numpy() if hasattr(p, "cpu") else np.asarray(p)
                 for p in planes)


def max_abs_diff(got, want):
    """Largest absolute difference of two (y, u, v) plane triples; a
    shape that differs counts as 255."""
    worst = 0
    for g, w in zip(host(got), host(want)):
        if g.shape != w.shape:
            return 255
        worst = max(worst, int(np.abs(g.astype(np.int16) - w.astype(np.int16)).max()))
    return worst


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def log_rates(t0, stamps, per, bins=5):
    """Frames a second in each fifth of the window, on standard error: a
    run that reads far off shows whether it was slow throughout or in a
    burst."""
    if not stamps:
        return
    span = (stamps[-1] - t0) / bins
    counts = [0] * bins
    for t in stamps:
        counts[min(bins - 1, int((t - t0) / span))] += per
    log("rate by fifth of the window: %s frames/s" % " ".join(
        "%.1f" % (c / span) for c in counts))
