"""Batched GOP decode: ExCamera's chunks of one string decoded in
lockstep by ``BatchedGopDecoder.decode_stream``, one frame of every chunk
a step.

Set-up makes the string from the seed (the frames on the card, each chunk
encoded by the port's encoder, as ExCamera's phase 1 would), builds the
decoder and decodes the string once.  The window replays the string back
to back, feeding the next frame position as the decoder takes it, until
the time is up; every frame fed is decoded and drained before the clock
stops.  The check decodes sampled chunks with the plain reference: one
chunk drawn from the seed in each half of the batch, the first frames of
each as the traffic file says, against what the window's last pass
produced for them.
"""
import random
import time

import torch

from benchmark.drivers import common
from benchmark.reference.vp8.decoder import Decoder as Reference


class Driver:
    def __init__(self, config, workload, seed, device, seconds):
        self.cfg, self.tr = config, workload["traffic"]
        self.seed, self.device = seed, device
        self.W, self.H = config["width"], config["height"]
        self.G = config["chunks_per_string"]
        self.F = config["chunk_frames"]
        rng = random.Random(seed)
        half = self.G // 2
        # (chunk, frames checked from its key frame on), one chunk a half
        self.samples = [(rng.randrange(h * half, (h + 1) * half), n)
                        for h, n in enumerate(self.tr["check_frames"])]

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup(self):
        from alfalfa_tpu_torch.parallel.gop import BatchedGopDecoder
        t0 = time.perf_counter()
        frames = common.frames(self.cfg, self.tr, self.seed, self.device)
        t1 = time.perf_counter()
        self.chunks = common.encode_chunks(frames, self.cfg, self.device)
        del frames
        common.log("frames %.3f s, encode %.3f s (%d bytes)" % (
            t1 - t0, time.perf_counter() - t1,
            sum(len(p) for c in self.chunks for p in c)))
        self.dec = BatchedGopDecoder(self.W, self.H, self.G, device=self.device,
                                     token_engine=self.tr.get("token_engine", "auto"))
        # every shape, and the host's parse threads and allocations into
        # their steady state: the first passes run slower
        t0 = time.perf_counter()
        for _ in self.dec.decode_stream(
                self._batches(passes=int(self.tr.get("warmup_passes", 1)))):
            pass
        self._sync()
        common.log("warm-up %.3f s" % (time.perf_counter() - t0))

    def _batches(self, passes=None, deadline=None):
        p = 0
        while passes is None or p < passes * self.F:
            if deadline is not None and time.perf_counter() >= deadline:
                return
            yield [self.chunks[g][p % self.F] for g in range(self.G)]
            p += 1

    def window(self, seconds):
        want = [(k, f) for k, n in self.samples for f in range(n)]
        self.kept = {}
        n = 0
        stamps = []
        t0 = time.perf_counter()
        for (y, u, v), _show in self.dec.decode_stream(
                self._batches(deadline=t0 + seconds)):
            pos = n % self.F
            for k, f in want:
                if f == pos:
                    self.kept[(k, f)] = (y[k].clone(), u[k].clone(), v[k].clone())
            n += 1
            stamps.append(time.perf_counter())
        self._sync()
        elapsed = time.perf_counter() - t0
        common.log_rates(t0, stamps, self.G)
        frames = n * self.G
        return {"frames": frames, "window_s": elapsed, "attempted": frames,
                "failed": 0, "geometry": {"G": self.G, "R": (self.H + 15) // 16,
                                          "C": (self.W + 15) // 16}}

    def release(self):
        self.kept = {k: common.host(v) for k, v in getattr(self, "kept", {}).items()}
        del self.dec
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, exact=True):
        """The plain reference's planes of every sampled frame."""
        out = {}
        for k, n in self.samples:
            ref = Reference(self.W, self.H, exact=exact)
            for f in range(n):
                try:
                    out[(k, f)] = ref.decode_frame(self.chunks[k][f])[1]
                except (ValueError, IndexError):
                    out[(k, f)] = None
                    break
        return out

    def compare(self, got, want):
        diff = max([common.max_abs_diff(got[key], planes)
                    for key, planes in want.items()
                    if key in got and planes is not None] or [0])
        return [("decoded_max_abs_diff", diff, 0),
                ("sampled_frames_missing", sum(k not in got for k in want), 0),
                ("sampled_frames_undecodable",
                 sum(p is None for p in want.values()), 0)]

    def check(self):
        return self.compare(self.kept, self.reference())

    def control(self):
        """The comparison with the reference's decode with its inverse
        transform's rounding dropped in the program's place (a decode that
        breaks bit-exactness);
        it has to come out not correct."""
        return self.compare(self.reference(exact=False), self.reference())
