"""Fuzz run of the port's native layer built with ASAN and UBSAN.

    ALFALFA_SANITIZE=1 LD_PRELOAD=$(g++ -print-file-name=libasan.so) \\
        ASAN_OPTIONS=detect_leaks=0:abort_on_error=1 \\
        UBSAN_OPTIONS=halt_on_error=1 \\
        python -m alfalfa_tpu_torch.tools.sanitize_fuzz
    python -m alfalfa_tpu_torch.tools.sanitize_fuzz --unsanitized --quick

The port parses bitstreams it did not write (Salsify's receiver decodes
datagrams off the network, ``xc decode`` reads any IVF) with the manual
index arithmetic of ``native/bitwork.cc``, ``mbparse.cc`` and
``tokensimd.cc``, and its host patch encodes through ``enckernel.cc``.
With ``ALFALFA_SANITIZE=1`` those are built with
``-fsanitize=address,undefined -fno-sanitize-recover=all`` into a directory
of their own (``native/_build.py``), and this tool runs every native
entry point through the port's host paths on the CPU (``device="cpu"``):

1. bit-exact decode of the fixtures and the natural corpus through
   ``FilePlayer``, against ``tests/fixtures/manifest.json`` and
   ``natural_manifest.json``;
2. the GOP token parse, engine by engine: ``parse_tokens_gop`` with
   "scalar" on 1 and 4 threads and "simd" (AVX-512) on 1, 2 and 4, at G =
   3, 12 and 32, each GOP's coefficients and nonzero flags equal to the
   per-frame parse; the serialize-parse loop of seeded token frames
   (sparse, the extreme categories, dense maximal values) through the
   port's writers, the per-frame parser and every engine;
3. truncations and byte flips (``corrupted_streams``: 24 and 40 of
   ``inter_176x144_q32.ivf``, seed 77) through
   ``Decoder(device="cpu", error_concealment=True)``: an exception is
   allowed, a crash is not; each frame's raster SHA-1 or exception class
   equals ``CORRUPT_TABLE``, which the card's memory check
   (``tools/poison_check.py``) holds the card's decode of the same bytes to;
4. host encode round trips: ``Encoder(device="cpu")`` in qp, rt, two-pass
   and SSIM-target modes (the writers), and the fast path's host patch
   (``fast_bpred=True``: ``enckernel.cc``'s B_PRED search, transforms,
   quantizer and inverse transform), each frame re-decoded to the
   encoder's minihash.

The sanitizer runtime must come first in the process: preload it
(``LD_PRELOAD``); ``import torch`` works under it, leak detection off
(Python's allocations live until exit).  ``--unsanitized`` runs the same
stages on the main build, ``--quick`` each stage once on the smallest
fixture, ``--record`` rewrites ``CORRUPT_TABLE`` from stage 3's decode.
Exits non-zero at the first failure; prints
``sanitize_fuzz: all stages passed`` last.  Imports no JAX.
"""
import hashlib
import importlib.util
import json
import os
import sys

import numpy as np
import torch

from alfalfa_tpu_torch.bitstream.header import UncompressedChunk
from alfalfa_tpu_torch.decoder import Decoder, FilePlayer
from alfalfa_tpu_torch.decoder.parse import FrameArrays, FrameParser
from alfalfa_tpu_torch.encoder import Encoder
from alfalfa_tpu_torch.native import bitwork
from alfalfa_tpu_torch.parallel.gop import _scatter_coeffs
from alfalfa_tpu_torch.state.decoder_state import DecoderState
from alfalfa_tpu_torch.util.ivf import IVFReader

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FIX = os.path.join(REPO, "tests", "fixtures")
CORRUPT_TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "corrupted_streams.json")
SMALLEST = "kf_64x48_q40.ivf"
NATURAL = ("pan_qcif_q48.ivf", "cut_qcif_q32.ivf", "grain_qcif_q112.ivf",
           "pan_90x48_q40.ivf", "still_qcif_q4.ivf", "object_qcif_tp_q48.ivf",
           "pan_qcif_rt_q48.ivf", "fade_qcif_q8.ivf")
# stage 2: (engine, threads) and the GOP widths; G > 8 runs two or more of
# the AVX-512 engine's 8-lane groups, over threads where threads > 1
ENGINES = (("scalar", 1), ("scalar", 4), ("simd", 1), ("simd", 2),
           ("simd", 4))
GOP_WIDTHS = (3, 12, 32)
TOKEN_CLIPS = ("inter_176x144_q32.ivf", "kf_176x144_q16.ivf",
               "inter_320x240_q40.ivf")
# stage 3
CORRUPT_CLIP, N_TRUNC, N_FLIP, CORRUPT_SEED = "inter_176x144_q32.ivf", 24, \
    40, 77


def say(line):
    print(line, flush=True)


def yuv_sha1(raster):
    return hashlib.sha1(raster.dump_bytes()).hexdigest()


# ---------------------------------------------------------------- stage 1

def stage1_decode(quick):
    with open(os.path.join(FIX, "manifest.json")) as f:
        man = json.load(f)
    with open(os.path.join(FIX, "natural_manifest.json")) as f:
        nat = json.load(f)
    if quick:
        clips = [(os.path.join(FIX, SMALLEST), man[SMALLEST])]
    else:
        clips = [(os.path.join(FIX, n), m) for n, m in sorted(man.items())
                 if "720" not in n and "320" not in n]
        clips += [(os.path.join(FIX, "natural", n), nat[n]) for n in NATURAL]
    for path, m in clips:
        d = hashlib.sha1()
        for raster in FilePlayer(path, device="cpu"):
            d.update(raster.dump_bytes())
        if d.hexdigest() != m["yuv_sha1"]:
            raise SystemExit("stage1: decode mismatch: %s" % path)
        say("  stage1 %s ok" % os.path.basename(path))


# ---------------------------------------------------------------- stage 2

def token_frames(path):
    """Every frame of ``path`` parsed in order by one FrameParser (header
    and macroblock headers), its tokens by the per-frame native parse:
    [(partitions, coeff_probs, skip, y2_coded, coeffs, has_nonzero)]."""
    ivf = IVFReader(path)
    state = DecoderState.initial(ivf.width, ivf.height)
    R, C = (ivf.height + 15) // 16, (ivf.width + 15) // 16
    frames = []
    for i in range(len(ivf)):
        chunk = UncompressedChunk(ivf.frame(i), ivf.width, ivf.height)
        header, arrays, probs = FrameParser(state, defer_tokens=True) \
            .parse(chunk)
        parts = chunk.dct_partitions(
            1 << header.log2_number_of_dct_partitions)
        coeffs = np.zeros((R, C, 25, 16), np.int16)
        nz = np.zeros((R, C), np.uint8)
        if not bitwork.parse_tokens(parts, R, C, probs.coeff_probs,
                                    arrays.skip_coeff, arrays.y2_coded,
                                    coeffs, nz):
            raise SystemExit("stage2: per-frame parse failed: %s frame %d"
                             % (path, i))
        frames.append((parts, probs.coeff_probs, arrays.skip_coeff,
                       arrays.y2_coded, coeffs, nz))
    return frames, R, C


def gop_parse(batch, R, C, engine, threads):
    """parse_tokens_gop over ``batch`` (token_frames' entries), expanded to
    dense: ((G, R, C, 25, 16) coefficients, (G, R, C) nonzero flags)."""
    G = len(batch)
    hnz = np.zeros((G, R, C), np.uint8)
    cs = bitwork.parse_tokens_gop(
        [b[0] for b in batch], R, C, [b[1] for b in batch],
        np.stack([b[2] for b in batch]).astype(np.uint8),
        np.stack([b[3] for b in batch]).astype(np.uint8), hnz,
        threads=threads, engine=engine)
    if cs is None:
        return None, hnz
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in cs.items()}
    dense = _scatter_coeffs(G, R, C, t["delta"], t["val"], t["desc_pos"],
                            t["desc_extra"].to(torch.int32), t["vesc_pos"],
                            t["vesc_val"])
    return dense.numpy(), hnz


def check_engines(batch, R, C, what):
    """Every engine of ENGINES (the SIMD ones where the host has AVX-512)
    on ``batch`` equals the per-frame parse; returns the engines run."""
    want_co = np.stack([b[4] for b in batch])
    want_nz = np.stack([b[5] for b in batch])
    ran = []
    for engine, threads in ENGINES:
        if engine == "simd" and not bitwork.simd_supported():
            continue
        before = dict(bitwork.engine_calls)
        co, nz = gop_parse(batch, R, C, engine, threads)
        if co is None:
            raise SystemExit("stage2: %s: %s on %d threads failed"
                             % (what, engine, threads))
        if bitwork.engine_calls[engine] != before[engine] + 1:
            raise SystemExit("stage2: %s: the %s engine did not run"
                             % (what, engine))
        if not (np.array_equal(co, want_co) and np.array_equal(nz, want_nz)):
            raise SystemExit("stage2: %s: %s on %d threads differs from the "
                             "per-frame parse" % (what, engine, threads))
        ran.append("%s/%d" % (engine, threads))
    return ran


def random_coeff_frame(rng, R, C, style):
    """Seeded token frame: "sparse-small", "extremes" (every token category,
    the cat5/cat6 extremes) or "dense-max" (every coefficient coded, |v| <=
    127); the slots a serialize-parse loop cannot carry zeroed, the skip
    flags from the coefficients (tests/test_token_fuzz.py's frames)."""
    a = FrameArrays(R, C)
    a.y2_coded[:] = rng.integers(0, 2, (R, C)).astype(bool)
    if style == "dense-max":
        a.coeffs[:] = rng.choice(np.array([-127, -67, -5, 4, 66, 127],
                                          np.int16), size=a.coeffs.shape)
    elif style == "extremes":
        mask = rng.random(a.coeffs.shape) < 0.05
        vals = rng.choice(np.array([-2047, -1000, -35, -11, -4, -1, 1, 2, 3,
                                    4, 6, 10, 18, 34, 66, 800, 2047],
                                   np.int16), size=a.coeffs.shape)
        a.coeffs[:] = np.where(mask, vals, 0)
    else:
        mask = rng.random(a.coeffs.shape) < 0.01
        a.coeffs[:] = np.where(mask, rng.integers(-6, 7, a.coeffs.shape),
                               0).astype(np.int16)
    a.coeffs[:, :, :16, 0] = np.where(a.y2_coded[:, :, None], 0,
                                      a.coeffs[:, :, :16, 0])
    a.coeffs[:, :, 24, :] = np.where(a.y2_coded[:, :, None],
                                     a.coeffs[:, :, 24, :], 0)
    nz = a.coeffs.any(axis=(2, 3))
    a.skip_coeff[:] = ~nz
    a.has_nonzero[:] = nz
    return a


def token_loop(style, G, seed):
    """G seeded ``style`` frames through the port's token writer, back
    through the per-frame parser and every GOP engine: each equal to the
    frame written."""
    rng = np.random.default_rng(seed)
    R, C = 5, 7
    probs = DecoderState.initial(C * 16, R * 16).probability_tables
    batch = []
    for _ in range(G):
        a = random_coeff_frame(rng, R, C, style)
        parts = bitwork.serialize_tokens(a, probs.coeff_probs, 1)
        co = np.zeros((R, C, 25, 16), np.int16)
        nz = np.zeros((R, C), np.uint8)
        if not bitwork.parse_tokens(parts, R, C, probs.coeff_probs,
                                    a.skip_coeff, a.y2_coded, co, nz) \
                or not np.array_equal(co, a.coeffs) \
                or not np.array_equal(nz.astype(bool), a.has_nonzero):
            raise SystemExit("stage2: %s: the serialize-parse loop differs"
                             % style)
        batch.append((parts, probs.coeff_probs, a.skip_coeff, a.y2_coded,
                      a.coeffs, a.has_nonzero.astype(np.uint8)))
    return check_engines(batch, R, C, "%s G=%d" % (style, G))


def stage2_token_engines(quick):
    if not bitwork.simd_supported():
        say("  stage2: this host has no AVX-512: the scalar engine only")
    clips = (SMALLEST,) if quick else TOKEN_CLIPS
    for clip in clips:
        frames, R, C = token_frames(os.path.join(FIX, clip))
        for G in (3,) if quick else GOP_WIDTHS:
            # G streams of the clip's frames, a different frame each
            batch = [frames[(7 * g) % len(frames)] for g in range(G)]
            ran = check_engines(batch, R, C, "%s G=%d" % (clip, G))
            say("  stage2 %s G=%d ok (%s)" % (clip, G, ", ".join(ran)))
    for k, style in enumerate(("sparse-small", "extremes", "dense-max")):
        G = 3 if quick else 12
        ran = token_loop(style, G, 99 + k)
        say("  stage2 token loop %s G=%d ok (%s)" % (style, G, ", ".join(ran)))
        if quick:
            break


# ---------------------------------------------------------------- stage 3

def _flip(rng, b):
    for _ in range(rng.randint(1, 6)):
        b[rng.randint(len(b))] ^= 1 << rng.randint(8)
    return b


def corrupted_streams(path=None, n_trunc=N_TRUNC, n_flip=N_FLIP,
                      seed=CORRUPT_SEED):
    """[(name, payloads)]: ``n_trunc`` streams of ``path`` with one frame
    truncated (frame t mod n cut at a seeded length), then ``n_flip`` with
    1-5 seeded bit flips in one seeded frame."""
    ivf = IVFReader(path or os.path.join(FIX, CORRUPT_CLIP))
    clean = [ivf.frame(i) for i in range(len(ivf))]
    rng = np.random.RandomState(seed)
    out = []
    for t in range(n_trunc):
        f = t % len(clean)
        cut = rng.randint(1, max(2, len(clean[f])))
        out.append(("trunc%02d_frame%d_at%d" % (t, f, cut),
                    clean[:f] + [clean[f][:cut]] + clean[f + 1:]))
    for k in range(n_flip):
        f = rng.randint(len(clean))
        b = _flip(rng, bytearray(clean[f]))
        out.append(("flip%02d_frame%d" % (k, f),
                    clean[:f] + [bytes(b)] + clean[f + 1:]))
    return out


def decode_outcomes(payloads, width, height, device, before_frame=None):
    """Each frame of ``payloads`` through one concealing Decoder on
    ``device``: its raster's SHA-1, or "raise:<exception class>" (the
    decoder goes on to the next frame)."""
    dec = Decoder(width, height, device=device, error_concealment=True)
    out = []
    for p in payloads:
        if before_frame is not None:
            before_frame()
        try:
            _, raster = dec.decode_frame(p)
            out.append(yuv_sha1(raster))
        except Exception as e:     # a decode error is allowed; a crash is not
            out.append("raise:" + type(e).__name__)
    return out


def stream_sha1(payloads):
    d = hashlib.sha1()
    for p in payloads:
        d.update(len(p).to_bytes(4, "little") + p)
    return d.hexdigest()


def load_table():
    """CORRUPT_TABLE: {name: {"stream_sha1", "frames": [outcome]}}."""
    with open(CORRUPT_TABLE) as f:
        return json.load(f)


def stage3_corruption(quick, record=False):
    if quick:
        path = os.path.join(FIX, SMALLEST)
        streams = corrupted_streams(path, 1, 1)
    else:
        path = os.path.join(FIX, CORRUPT_CLIP)
        streams = corrupted_streams(path)
    ivf = IVFReader(path)
    got = {name: {"stream_sha1": stream_sha1(p),
                  "frames": decode_outcomes(p, ivf.width, ivf.height, "cpu")}
           for name, p in streams}
    raised = sum(o.startswith("raise:") for v in got.values()
                 for o in v["frames"])
    if record:
        with open(CORRUPT_TABLE, "w") as f:
            json.dump(got, f, indent=1, sort_keys=True)
            f.write("\n")
    elif not quick:
        want = load_table()
        bad = [n for n in got if got[n] != want.get(n)]
        if bad or set(want) != set(got):
            raise SystemExit("stage3: the CPU decode differs from %s: %s"
                             % (os.path.basename(CORRUPT_TABLE), bad))
    say("  stage3 corruption fuzz ok (%d streams, %d frames, %d raised)"
        % (len(streams), sum(len(p) for _, p in streams), raised))


# ---------------------------------------------------------------- stage 4

def gen_clip(*args, **kw):
    """tests/fixtures/gen_natural.py's seeded camera-like clip (numpy)."""
    spec = importlib.util.spec_from_file_location(
        "gen_natural", os.path.join(FIX, "gen_natural.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.gen_clip(*args, **kw)


def stage4_encode(quick):
    w, h = (64, 48) if quick else (96, 64)
    clip = gen_clip(w, h, 2 if quick else 4, seed=55, cut_at=None
                    if quick else 2)
    modes = ((("best", "qp"),) if quick else
             (("best", "qp"), ("rt", "qp"), ("best", "twopass"),
              ("best", "ssim"), ("rt", "host_patch")))
    for quality, mode in modes:
        enc = Encoder(w, h, quality=quality, two_pass=mode == "twopass",
                      device="cpu", fast=mode == "host_patch",
                      fast_bpred=mode == "host_patch")
        dec = Decoder(w, h, device="cpu")
        patched = 0
        for fi, f in enumerate(clip):
            kf = fi == 0
            if mode == "ssim":
                payload = enc.encode_with_minimum_ssim(f, 0.7, key_frame=kf)
            else:
                payload = enc.encode_with_quantizer(f, 40, key_frame=kf)
            patched += enc.patched_mbs if not kf else 0
            dec.decode_frame(payload)
            if dec.minihash() != enc.minihash():
                raise SystemExit("stage4: %s/%s: the decoder's minihash "
                                 "differs from the encoder's at frame %d"
                                 % (quality, mode, fi))
        if mode == "host_patch" and not patched:
            raise SystemExit("stage4: the host patch patched no macroblock")
        say("  stage4 encode %s/%s ok%s" % (
            quality, mode, " (%d macroblocks host-patched)" % patched
            if mode == "host_patch" else ""))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    unsanitized, quick = "--unsanitized" in argv, "--quick" in argv
    record = "--record" in argv
    if os.environ.get("ALFALFA_SANITIZE") != "1" and not unsanitized:
        raise SystemExit("run with ALFALFA_SANITIZE=1 and libasan preloaded "
                         "(module docstring), or with --unsanitized")
    if record and quick:
        raise SystemExit("--record writes the 64 streams' table: not with "
                         "--quick")
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    stage1_decode(quick)
    stage2_token_engines(quick)
    stage3_corruption(quick, record)
    stage4_encode(quick)
    if "jax" in sys.modules or "alfalfa_tpu" in sys.modules:
        raise SystemExit("sanitize_fuzz imported the JAX package")
    say("sanitize_fuzz: all stages passed")


if __name__ == "__main__":
    main()
