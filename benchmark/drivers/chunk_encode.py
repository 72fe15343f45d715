"""ExCamera's phase 1 on one worker: chunk after chunk of seeded frames,
each encoded by a fresh ``Encoder`` (a key frame, then interframes, at the
configuration's quantizer) and terminated as ``parallel.cluster``'s chunk
worker and ``xc terminate-chunk`` do it (every reference refreshed on the
last frame, the chunk decoded along by the port's ``Decoder``, the exit
state written by ``serdes.save_decoder``).  Closed loop: the next chunk
starts when one is out.  A chunk's frames count when its terminated
payloads and exit state are out; the chunk in progress at the end of the
window is finished and counted, and the rate is taken over the whole
time.

Set-up makes a pool of frames on the card from the seed (one string's
worth; chunk c takes the pool's chunk c modulo the string) and encodes
and terminates one chunk to warm every shape up.  The check takes one of
the window's first chunks, drawn from the seed, and decodes its payloads
with the plain reference: each frame against the encoder's own
reconstruction after it, the last against the exit state's reference
planes.  It then holds the encoder's decisions to the configuration:
every frame's quantizer to the one the configuration states; every
frame's loop-filter level to the search the configuration states (a climb
from level 0 by the luma SSIM against the source, stopping at the first
level that does not improve it: the level coded scores better than the
one below it and no worse than the one above, each filtered by the
reference); and the decoded frames to the source (the largest mean
squared error of a plane, under the cell's limit).

``CONTROLS`` names the faults ``benchmark/control.py`` plants, each of
which has to come out not correct.
"""
import contextlib
import random
import struct
import time

import numpy as np
import torch

from benchmark.drivers import common
from benchmark.reference.ssim import ssim
from benchmark.reference.vp8.decoder import Decoder as Reference

# the faults of ``Driver.planted`` and the precision control
CONTROLS = ("precision", "lf_search_left_out", "motion_search_cut",
            "input_ignored")


def _exit_planes(state, W, H):
    """The LAST reference's planes from the tail of a ``.state`` file
    (the REF_LAST record: tag 8, a u32 length, y, u, v)."""
    R, C = (H + 15) // 16, (W + 15) // 16
    n = R * C * 384
    if len(state) < n + 5 or state[-n - 5] != 8 or \
            struct.unpack("<I", state[-n - 4:-n])[0] != n:
        return None
    raw = np.frombuffer(state[-n:], np.uint8)
    y = raw[:R * C * 256].reshape(R * 16, C * 16)
    u = raw[R * C * 256:R * C * 320].reshape(R * 8, C * 8)
    v = raw[R * C * 320:].reshape(R * 8, C * 8)
    return y, u, v


def _quantizer_off(header, state, qi):
    """True where the frame is not coded at quantizer index ``qi`` with no
    deltas and no segment adjusting it."""
    q = header.quant_indices
    seg = state.segmentation
    return bool(q.y_ac_qi != qi or any((q.y_dc, q.y2_dc, q.y2_ac, q.uv_dc, q.uv_ac))
                or (seg is not None and np.any(seg.quantizer_adjustments)))


def judge(kept, W, H, qi, limits):
    """The comparison of one chunk: ``kept`` holds its payloads, exit
    state, the program's reconstruction after each frame (or the planes
    put in their place) and the source frames, all on the host.  Returns
    [(name, value, limit)] for every number that has a limit in
    ``limits``, and {name: value} of every number read."""
    payloads, state, recon, source = (kept[k] for k in
                                      ("payloads", "state", "recon", "source"))
    F = len(source)
    ref = Reference(W, H)
    diff = bad = qi_off = 0
    climb = mse = 0.0
    planes = None
    cw, ch = (W + 1) // 2, (H + 1) // 2
    around = lambda header: [lv for lv in (header.loop_filter_level - 1,
                                           header.loop_filter_level + 1)
                             if 0 <= lv <= 63]
    for payload, mine, src in zip(payloads, recon, source):
        try:
            _, planes, header, others = ref.decode_frame(payload, around)
        except (ValueError, IndexError):
            bad += 1
            planes = None
            break
        diff = max(diff, common.max_abs_diff(mine, planes))
        qi_off += _quantizer_off(header, ref.state, qi)
        for p, s, (h, w) in zip(planes, src, ((H, W), (ch, cw), (ch, cw))):
            e = p[:h, :w].astype(np.float64) - s[:h, :w]
            mse = max(mse, float(np.mean(e * e)))
        # the loop-filter climb: the level coded against its neighbours
        score = ssim(planes[0][:H, :W], src[0][:H, :W])
        for y in others.values():
            climb = max(climb, ssim(y[:H, :W], src[0][:H, :W]) - score)
    exit_planes = kept.get("exit_planes") or _exit_planes(state, W, H)
    exit_diff = 255 if exit_planes is None or planes is None else \
        common.max_abs_diff(exit_planes, planes)
    sizes = [len(p) for p in payloads]
    numbers = {
        "encoder_recon_max_abs_diff": diff,
        "exit_state_max_abs_diff": exit_diff,
        "payloads_undecodable": bad,
        "chunk_frames_missing": F - min(len(payloads), len(recon)),
        "quantizer_mismatches": qi_off,
        "lf_climb_gap": climb,
        "source_mse_max": mse,
        "chunk_bytes": sum(sizes),
        "inter_over_key_bytes": (sum(sizes[1:]) / max(1, len(sizes) - 1)
                                 / max(1, sizes[0]) if sizes else 0.0),
    }
    return [(n, numbers[n], limits[n]) for n in limits if n in numbers], numbers


class Driver:
    # the control needs the window's sampled chunk
    CONTROL_WINDOW_S = 1.0

    def __init__(self, config, workload, seed, device, seconds):
        self.cfg, self.tr = config, workload["traffic"]
        self.seed, self.device = seed, device
        self.W, self.H = config["width"], config["height"]
        self.F = config["chunk_frames"]
        self.sample = random.Random(seed).randrange(int(self.tr["check_among_first"]))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup(self):
        t0 = time.perf_counter()
        self.frames = common.frames(self.cfg, self.tr, self.seed, self.device)
        common.log("frames %.3f s" % (time.perf_counter() - t0))
        t0 = time.perf_counter()
        self._chunk(0, keep=False)
        self._sync()
        common.log("warm-up chunk %.3f s" % (time.perf_counter() - t0))

    def _chunk(self, c, keep):
        """Encode and terminate chunk ``c``; returns (payloads, the exit
        state bytes, the encoder's reconstruction after each frame, the
        source frames) when ``keep``, else (payloads, the exit state)."""
        from alfalfa_tpu_torch.decoder.decoder import Decoder
        from alfalfa_tpu_torch.encoder.encoder import Encoder
        from alfalfa_tpu_torch.encoder.serializer import refresh_all_references
        from alfalfa_tpu_torch.state import serdes
        n_chunks = len(self.frames) // self.F
        frames = self.frames[(c % n_chunks) * self.F:(c % n_chunks + 1) * self.F]
        enc = Encoder(self.W, self.H, quality=self.cfg["quality"],
                      two_pass=self.cfg.get("two_pass", False), device=self.device)
        payloads, recon = [], []
        for f in frames:
            payloads.append(enc.encode_with_quantizer(f, self.cfg["y_ac_qi"]))
            if keep:
                last = enc.references.last
                recon.append(tuple(p.clone() for p in (last.y, last.u, last.v)))
        dec = Decoder(self.W, self.H, device=self.device)
        out = []
        for i, payload in enumerate(payloads):
            if i == len(payloads) - 1:
                payload = refresh_all_references(payload, dec.state.copy(),
                                                 self.W, self.H, show=True)
            dec.decode_frame(payload)
            out.append(bytes(payload))
        state = serdes.save_decoder(dec.state, dec.references)
        return (out, state, recon, frames) if keep else (out, state)

    def window(self, seconds):
        t0 = time.perf_counter()
        c = 0
        self.kept = None
        stamps = []
        while c <= self.sample or time.perf_counter() < t0 + seconds:
            got = self._chunk(c, keep=c == self.sample)
            if c == self.sample:
                self.kept = got
            c += 1
            stamps.append(time.perf_counter())
        self._sync()
        elapsed = time.perf_counter() - t0
        common.log_rates(t0, stamps, self.F)
        frames = c * self.F
        return {"frames": frames, "window_s": elapsed, "attempted": frames,
                "failed": 0, "chunks": c,
                "geometry": {"G": 1, "R": (self.H + 15) // 16,
                             "C": (self.W + 15) // 16, "Q": 1}}

    def judged(self, name=None):
        """The arguments of ``judge`` for the window's sampled chunk, on the
        host; ``name`` "precision": the reference's decode with its inverse
        transform's rounding dropped in place of the program's
        reconstruction and exit state."""
        if self.kept is None:
            return None
        payloads, state, recon, source = self.kept
        kept = {"payloads": payloads, "state": state,
                "recon": [common.host(x) for x in recon],
                "source": [common.host(x) for x in source]}
        if name == "precision":
            ref = Reference(self.W, self.H, exact=False)
            kept["recon"] = [ref.decode_frame(p)[1] for p in payloads]
            kept["exit_planes"] = kept["recon"][-1]
        return (kept, self.W, self.H, self.cfg["y_ac_qi"],
                self.tr["check_limits"])

    def release(self):
        self.args = self.judged()
        self.kept = self.frames = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        if self.args is None:
            return [("sampled_chunk_missing", 1, 0)]
        return judge(*self.args)[0] + [("sampled_chunk_missing", 0, 0)]

    @contextlib.contextmanager
    def planted(self, name):
        """The program with the fault ``name`` planted (one of
        ``CONTROLS``; "precision" plants none): the loop-filter search
        left out (every frame at level 0), the motion search cut to the
        program's realtime one (new vectors searched at one macroblock in
        16), or the encoder's input ignored (it encodes the frame half a
        string away)."""
        from alfalfa_tpu_torch.encoder import encode_inter
        from alfalfa_tpu_torch.encoder.encoder import Encoder
        if name == "lf_search_left_out":
            target, attr, fn = Encoder, "_search_loopfilter", _no_lf_search
        elif name == "motion_search_cut":
            orig_inputs = encode_inter.kernel_inputs

            def fn(*a):
                args = list(orig_inputs(*a))
                args[8] = True          # K8's realtime flag
                return tuple(args)
            target, attr = encode_inter, "kernel_inputs"
        elif name == "input_ignored":
            frames = self.frames
            index = {id(f): i for i, f in enumerate(frames)}
            orig_encode = Encoder.encode_with_quantizer

            def fn(enc, yuv, qi, key_frame=None):
                i = index.get(id(yuv))
                if i is not None:
                    yuv = frames[(i + len(frames) // 2) % len(frames)]
                return orig_encode(enc, yuv, qi, key_frame)
            target, attr = Encoder, "encode_with_quantizer"
        else:
            yield
            return
        orig = getattr(target, attr)
        setattr(target, attr, fn)
        try:
            yield
        finally:
            setattr(target, attr, orig)


def _no_lf_search(enc, header, arrays, state, recon, oy, key_frame):
    """``Encoder._search_loopfilter`` without its search: level 0."""
    from alfalfa_tpu_torch.bitstream.header import ModeRefLFDeltaUpdate
    from alfalfa_tpu_torch.state.decoder_state import FilterAdjustments, Raster
    from alfalfa_tpu_torch.util.ssim import ssim as program_ssim
    header.mode_lf_adjustments_enabled = True
    header.mode_lf_adjustments = ModeRefLFDeltaUpdate([0] * 4, [0] * 4)
    state.filter_adjustments = FilterAdjustments.create(header)
    planes = [p.clone() for p in (recon.y, recon.u, recon.v)]
    h, w = enc.height, enc.width
    score = float(program_ssim(planes[0][:h, :w], oy[:h, :w]))
    return 0, Raster(w, h, *planes), score
