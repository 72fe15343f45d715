"""`xc` - the command line of the port (mirrors the reference's frontend
programs and ExCamera's toolchain):

  decode        IVF -> y4m (vp8decode, incl. -s input state)
  decode-raw    IVF -> raw planar YUV on stdout (decode-to-stdout)
  decode-bundle decode a sequence of IVFs named on stdin as one stream,
                verifying entry minihashes (xc-decode-bundle)
  play          decode an IVF and display it live (vp8play; needs OpenCV
                and a display)
  display-jpeg  show one JPEG file (display-jpeg)
  webcam        show live camera frames (real-webcam)
  enc           y4m / IVF -> VP8 IVF (xc-enc: constant quantizer, minimum
                SSIM or target sizes; -I / -O encoder state files; --fast:
                rt interframes through the fast path; -r: the rebase of a
                prediction IVF against -I's state, ExCamera's)
  enc-parallel  y4m -> VP8 IVF by parallel chunk encodes and the serial
                rebase (ExCamera's cluster encode)
  terminate-chunk rewrite the last interframe to refresh all references,
                optionally with the stream's exit state (xc-terminate-chunk)
  dump          decode through frame N, write the decoder state (xc-dump)
  diff          structural diff of two state files (xc-diff)
  comp-states   bit-level comparison of two state files (comp-states)
  ssim          frame-by-frame SSIM of two videos, y4m or IVF (xc-ssim)
  framesize     per-frame compressed sizes (xc-framesize)
  merge         concatenate IVFs (xc-merge)
  zero-out-residues prediction-only stream for rebasing experiments
                (xc-zero-out-residues)
  dissect       bitstream analyzer (xc-dissect)
  run-contest   Salsify's sender -> a trace-shaped emulated link ->
                Salsify's receiver, in one process (scripts/run-contest)

Frames are reconstructed and encoded on ``--device`` (default ``cuda``;
``cpu`` runs the kernels' plain versions); the commands that only read
IVF or state files run on the host and take no device.  ``--timings``
prints the stage timings on stderr, ``--profile DIR`` writes a
torch.profiler Chrome trace into DIR.  Run from the repository root:

    python -m alfalfa_tpu_torch.cli.xc decode-raw in.ivf > out.yuv
    python -m alfalfa_tpu_torch.cli.xc enc -o out.ivf --y-ac-qi 48 in.y4m
    python -m alfalfa_tpu_torch.cli.xc terminate-chunk c0.ivf c0t.ivf \
        -O c0t.state
    python -m alfalfa_tpu_torch.cli.xc enc -r -I c0t.state -p pred.ivf \
        -o rebased.ivf in.y4m
    python -m alfalfa_tpu_torch.cli.xc merge c0t.ivf rebased.ivf -o all.ivf
    python -m alfalfa_tpu_torch.cli.xc enc-parallel -y 48 -c 6 -j 4 \
        -o out.ivf in.y4m
    python -m alfalfa_tpu_torch.cli.xc --timings ssim all.ivf in.y4m
    python -m alfalfa_tpu_torch.cli.xc run-contest --frames 30 in.y4m
"""
import argparse
import sys


def _player_with_state(args):
    from alfalfa_tpu_torch.decoder import FilePlayer
    from alfalfa_tpu_torch.decoder.decoder import Decoder
    from alfalfa_tpu_torch.util.ivf import IVFReader

    if not args.state:
        return FilePlayer(args.input, device=args.device)

    # the entry-hash check must run against the LOADED state, so bypass
    # FilePlayer's fresh-decoder constructor check
    from alfalfa_tpu_torch.state import serdes
    state, refs = serdes.load_decoder(args.state, device=args.device)
    player = FilePlayer.__new__(FilePlayer)
    player.ivf = IVFReader(args.input)
    player.width, player.height = player.ivf.width, player.ivf.height
    player.decoder = Decoder(player.width, player.height, state=state,
                             references=refs, device=args.device)
    player.frame_no = 0
    if not player.decoder.minihash_match(player.ivf.expected_decoder_minihash):
        raise SystemExit("xc decode: state does not match IVF entry minihash")
    return player


def cmd_decode(args):
    from alfalfa_tpu_torch.util.y4m import Y4MWriter

    player = _player_with_state(args)
    writer = None
    for raster in player:
        if writer is None:
            writer = Y4MWriter(args.output, player.width, player.height,
                               player.ivf.frame_rate, player.ivf.time_scale)
        writer.append_frame(*raster.display())
    if writer:
        writer.close()


def cmd_decode_raw(args):
    player = _player_with_state(args)
    out = sys.stdout.buffer
    for raster in player:
        out.write(raster.dump_bytes())
    out.flush()


def cmd_play(args):
    """vp8play: decode an IVF on --device and display it live
    (frontend/vp8play.cc:38)."""
    import time
    from alfalfa_tpu_torch.display import VideoDisplay

    player = _player_with_state(args)
    display = VideoDisplay(player.width, player.height,
                           fullscreen=args.fullscreen)
    interval = player.ivf.time_scale / max(1, player.ivf.frame_rate)
    next_due = time.monotonic()
    for raster in player:
        now = time.monotonic()
        if next_due > now:
            time.sleep(next_due - now)
        next_due += interval
        display.draw(raster)
    display.close()


def cmd_display_jpeg(args):
    """Decode one JPEG file and show it (salsify/display-jpeg.cc:45-76)."""
    import time
    from alfalfa_tpu_torch.display import VideoDisplay
    from alfalfa_tpu_torch.input.jpeg import JPEGDecompresser

    with open(args.input, "rb") as f:
        data = f.read()
    y, u, v = JPEGDecompresser().decompress(data)
    display = VideoDisplay(y.shape[1], y.shape[0],
                           fullscreen=args.fullscreen)
    display.draw((y, u, v))
    time.sleep(args.seconds)
    display.close()


def cmd_webcam(args):
    """Show live camera frames (salsify/real-webcam.cc:46-120)."""
    from alfalfa_tpu_torch.display import VideoDisplay
    from alfalfa_tpu_torch.input.camera import Camera

    cam = Camera(args.device, pixel_format=args.pixfmt)
    display = VideoDisplay(cam.display_width, cam.display_height,
                           fullscreen=args.fullscreen)
    try:
        while True:
            frame = cam.get_next_frame()
            if frame is None:
                break
            display.draw(frame)
    except KeyboardInterrupt:
        pass
    display.close()


def cmd_decode_bundle(args):
    """Decode the IVFs named on stdin as one continuous stream on --device,
    checking each file's entry minihash against the decoder's
    (decode-bundle.cc)."""
    from alfalfa_tpu_torch.decoder.decoder import Decoder
    from alfalfa_tpu_torch.util.ivf import IVFReader
    from alfalfa_tpu_torch.util.y4m import Y4MWriter

    paths = [line.strip() for line in sys.stdin if line.strip()]
    decoder = writer = None
    for path in paths:
        ivf = IVFReader(path)
        if decoder is None:
            decoder = Decoder(ivf.width, ivf.height, device=args.device)
            writer = Y4MWriter(args.output, ivf.width, ivf.height,
                               ivf.frame_rate, ivf.time_scale)
        if not decoder.minihash_match(ivf.expected_decoder_minihash):
            raise SystemExit(f"{path}: decoder entry state mismatch "
                             f"(have {decoder.minihash():08x}, "
                             f"expect {ivf.expected_decoder_minihash:08x})")
        for payload in ivf:
            shown, raster = decoder.decode_frame(payload)
            if shown:
                writer.append_frame(*raster.display())
    if writer:
        writer.close()


def cmd_dump(args):
    """Decode through frame -f (default: the last) on --device and write
    the decoder state (xc-dump)."""
    from alfalfa_tpu_torch.decoder import FilePlayer
    from alfalfa_tpu_torch.state import serdes

    player = FilePlayer(args.input, device=args.device)
    target = (args.frame_number if args.frame_number is not None
              else len(player.ivf) - 1)
    while player.frame_no <= target and not player.eof():
        player.decode(player.ivf.frame(player.frame_no))
        player.frame_no += 1
    serdes.save_decoder(player.decoder.state, player.decoder.references,
                        args.output)


def cmd_diff(args):
    """Structural diff of two state files (xc-diff): 0 if they agree."""
    import numpy as np
    from alfalfa_tpu_torch.state import serdes

    s1, r1 = serdes.load_decoder(args.first, device="cpu")
    s2, r2 = serdes.load_decoder(args.second, device="cpu")
    same = True
    if (s1.width, s1.height) != (s2.width, s2.height):
        print(f"dimensions differ: {s1.width}x{s1.height} vs "
              f"{s2.width}x{s2.height}")
        same = False
    for name in ("coeff_probs", "y_mode_probs", "uv_mode_probs", "mv_probs"):
        a = getattr(s1.probability_tables, name)
        b = getattr(s2.probability_tables, name)
        d = int((a != b).sum())
        if d:
            print(f"{name}: {d} entries differ")
            same = False
    for plane, a, b in zip("yuv", r1.last.to_host(), r2.last.to_host()):
        d = int((a != b).sum())
        if d:
            print(f"last.{plane}: {d} pixels differ (max "
                  f"{int(np.abs(a.astype(int) - b.astype(int)).max())})")
            same = False
    print("states are identical" if same else "states differ")
    return 0 if same else 1


def cmd_comp_states(args):
    """Bits that differ between two state files (comp-states): 0 if
    none."""
    import numpy as np

    with open(args.first, "rb") as f1, open(args.second, "rb") as f2:
        d1 = np.frombuffer(f1.read(), np.uint8)
        d2 = np.frombuffer(f2.read(), np.uint8)
    n = min(len(d1), len(d2))
    diff_bits = int(np.unpackbits(d1[:n] ^ d2[:n]).sum())
    diff_bits += 8 * abs(len(d1) - len(d2))
    print(f"{diff_bits} bits differ")
    return 0 if diff_bits == 0 else 1


def cmd_ssim(args):
    """Luma SSIM of each frame pair (xc-ssim), both videos' planes on
    --device (an IVF decoded there)."""
    import torch
    from alfalfa_tpu_torch.decoder import FilePlayer
    from alfalfa_tpu_torch.util.ssim import ssim
    from alfalfa_tpu_torch.util.y4m import Y4MReader

    device = torch.device(args.device)

    def frames(path):
        if path.endswith(".y4m"):
            for y, _, _ in Y4MReader(path):
                yield torch.tensor(y, device=device)
        else:
            for r in FilePlayer(path, device=device):
                yield r.y[:r.display_height, :r.display_width]

    for i, (a, b) in enumerate(zip(frames(args.first), frames(args.second))):
        print(f"{i}, {float(ssim(a, b)):.7f}")


def cmd_framesize(args):
    from alfalfa_tpu_torch.util.ivf import IVFReader

    for frame in IVFReader(args.input):
        print(len(frame))


def cmd_merge(args):
    from alfalfa_tpu_torch.util.ivf import IVFReader, IVFWriter

    first = IVFReader(args.inputs[0])
    with IVFWriter(args.output, first.fourcc, first.width, first.height,
                   first.frame_rate, first.time_scale,
                   first.expected_decoder_minihash) as w:
        for path in args.inputs:
            for frame in IVFReader(path):
                w.append_frame(frame)


def cmd_terminate_chunk(args):
    """Rewrite the last interframe to refresh all references
    (xc-terminate-chunk.cc:82-106); with an output state, the terminated
    stream is decoded on --device from the initial state and its exit
    state written."""
    from alfalfa_tpu_torch.bitstream.header import UncompressedChunk
    from alfalfa_tpu_torch.decoder.parse import FrameParser
    from alfalfa_tpu_torch.encoder.serializer import refresh_all_references
    from alfalfa_tpu_torch.state.decoder_state import DecoderState
    from alfalfa_tpu_torch.util.ivf import IVFReader, IVFWriter

    src = IVFReader(args.input)
    w, h = src.width, src.height
    state = DecoderState.initial(w, h)
    with IVFWriter(args.output, "VP80", w, h, src.frame_rate,
                   src.time_scale, src.expected_decoder_minihash) as writer:
        for i, payload in enumerate(src):
            if i == len(src) - 1:
                payload = refresh_all_references(payload, state, w, h)
            else:
                FrameParser(state).parse(UncompressedChunk(payload, w, h))
            writer.append_frame(payload)

    out_state = args.output_state or args.output_state_opt
    if out_state:
        from alfalfa_tpu_torch.decoder.decoder import Decoder
        from alfalfa_tpu_torch.state import serdes
        dec = Decoder(w, h, device=args.device)
        for payload in IVFReader(args.output):
            dec.decode_frame(payload)
        serdes.save_decoder(dec.state, dec.references, out_state)


def cmd_zero_out_residues(args):
    """Zero every interframe's residues, keeping its modes and vectors,
    and re-serialize every frame (xc-zero-out-residues.cc)."""
    from alfalfa_tpu_torch.bitstream.header import UncompressedChunk
    from alfalfa_tpu_torch.decoder.parse import FrameParser
    from alfalfa_tpu_torch.encoder.serializer import serialize_frame
    from alfalfa_tpu_torch.state.decoder_state import DecoderState
    from alfalfa_tpu_torch.util.ivf import IVFReader, IVFWriter

    src = IVFReader(args.input)
    w, h = src.width, src.height
    state = DecoderState.initial(w, h)
    with IVFWriter(args.output, "VP80", w, h, src.frame_rate,
                   src.time_scale) as writer:
        for payload in src:
            chunk = UncompressedChunk(payload, w, h)
            header, arrays, frame_probs = FrameParser(state).parse(chunk)
            if not chunk.key_frame:
                arrays.densify_coeffs()[:] = 0
                arrays.has_nonzero[:] = False
                if header.prob_skip_false is not None:
                    arrays.skip_coeff[:] = True
            writer.append_frame(serialize_frame(
                header, arrays, frame_probs, chunk.key_frame, w, h,
                chunk.show_frame))


def cmd_enc(args):
    if args.reencode:
        return cmd_enc_rebase(args)
    import time
    from alfalfa_tpu_torch.decoder import FilePlayer
    from alfalfa_tpu_torch.encoder import Encoder
    from alfalfa_tpu_torch.state import serdes
    from alfalfa_tpu_torch.util.ivf import IVFReader, IVFWriter
    from alfalfa_tpu_torch.util.y4m import Y4MReader

    if args.input_format == "y4m":
        reader = Y4MReader(args.input)
        frames = iter(reader)
        width, height = reader.width, reader.height
    else:
        ivf = IVFReader(args.input)
        width, height = ivf.width, ivf.height
        frames = (r.display() for r in FilePlayer(args.input,
                                                   device=args.device))

    frame_sizes = None
    if args.frame_sizes:
        # one target size (bytes) per line, matched to frames in order
        # (xc-enc.cc:70-72, 366-372)
        with open(args.frame_sizes) as f:
            frame_sizes = [int(line) for line in f if line.strip()]
    elif args.ssim is None and args.y_ac_qi is None:
        args.ssim = 0.90  # xc-enc's default mode is SSIM 0.90
    if args.y_ac_qi is not None and not 0 <= args.y_ac_qi <= 127:
        print("xc enc: error: y-ac-qi must be in [0, 127]", file=sys.stderr)
        return 2
    if args.fast and args.quality != "rt":
        print("xc enc: error: --fast requires -q rt", file=sys.stderr)
        return 2
    enc = Encoder(width, height, quality=args.quality,
                  two_pass=args.two_pass, device=args.device, fast=args.fast)
    entry_minihash = 0
    if args.input_state:
        enc.state, enc.references = serdes.load_decoder(args.input_state,
                                                        device=args.device)
        enc.frame_no = 1  # continue the chunk: no leading key frame
        entry_minihash = enc.minihash()
    with IVFWriter(args.output, "VP80", width, height, 1, 1,
                   entry_minihash) as writer:
        for i, frame in enumerate(frames):
            t0 = time.time()
            if frame_sizes is not None:
                target = frame_sizes[min(i, len(frame_sizes) - 1)]
                payload = enc.encode_with_target_size(frame, target)
                print(f" [target_size={target}] ", end="", file=sys.stderr)
            elif args.ssim is not None:
                payload = enc.encode_with_minimum_ssim(frame, args.ssim)
            else:
                payload = enc.encode_with_quantizer(frame, args.y_ac_qi)
            print(f"Encoding frame #{i}... done "
                  f"({(time.time() - t0) * 1000:.0f} ms).", file=sys.stderr)
            writer.append_frame(payload)
    if args.output_state:
        serdes.save_decoder(enc.state, enc.references, args.output_state)


def cmd_enc_rebase(args):
    """Rebase mode (xc-enc -r, xc-enc.cc:262-326): re-encode a prediction
    IVF against the inherited encoder state of -I, reusing its modes and
    vectors."""
    from alfalfa_tpu_torch.decoder.decoder import Decoder
    from alfalfa_tpu_torch.encoder import Encoder
    from alfalfa_tpu_torch.encoder import reencode as RB
    from alfalfa_tpu_torch.state import serdes
    from alfalfa_tpu_torch.util.ivf import IVFReader, IVFWriter
    from alfalfa_tpu_torch.util.y4m import Y4MReader

    if not args.pred_ivf:
        print("xc enc: error: -r needs -p/--pred-ivf", file=sys.stderr)
        return 2
    originals = list(Y4MReader(args.input))
    pred_ivf = IVFReader(args.pred_ivf)
    w, h = pred_ivf.width, pred_ivf.height

    # the prediction stream decodes from its own entry state
    state = refs = None
    if args.pred_state:
        state, refs = serdes.load_decoder(args.pred_state,
                                          device=args.device)
    pred_decoder = Decoder(w, h, state=state, references=refs,
                           device=args.device)
    if not pred_decoder.minihash_match(pred_ivf.expected_decoder_minihash):
        raise SystemExit("xc enc -r: prediction IVF entry state mismatch")
    prediction_frames = RB.parse_prediction(list(pred_ivf), pred_decoder)

    enc = Encoder(w, h, device=args.device)
    entry_minihash = 0
    if args.input_state:
        enc.state, enc.references = serdes.load_decoder(args.input_state,
                                                        device=args.device)
        entry_minihash = enc.minihash()
    with IVFWriter(args.output, "VP80", w, h, 1, 1, entry_minihash) as writer:
        RB.reencode(enc, originals, prediction_frames, args.kf_q_weight,
                    args.extra_frame_chunk, writer)
    if args.output_state:
        serdes.save_decoder(enc.state, enc.references, args.output_state)


def cmd_enc_parallel(args):
    """ExCamera's cluster encode: parallel chunk encodes and the serial
    rebase (the reference's xc-enc -I/-O under mu, in one command), every
    worker on --device."""
    import time
    from alfalfa_tpu_torch.parallel.cluster import parallel_encode
    from alfalfa_tpu_torch.util.ivf import IVFWriter
    from alfalfa_tpu_torch.util.y4m import Y4MReader

    reader = Y4MReader(args.input)
    frames = list(reader)
    t0 = time.time()
    with IVFWriter(args.output, "VP80", reader.width, reader.height,
                   1, 1, 0) as writer:
        parallel_encode(frames, reader.width, reader.height, writer,
                        y_ac_qi=args.y_ac_qi, ssim_target=args.ssim,
                        chunk_frames=args.chunk_frames, workers=args.workers,
                        quality=args.quality, two_pass=args.two_pass,
                        kf_q_weight=args.kf_q_weight,
                        log=lambda m: print(m, file=sys.stderr),
                        device=args.device)
    dt = time.time() - t0
    print(f"{len(frames)} frames in {dt:.1f}s = {len(frames) / dt:.2f} fps",
          file=sys.stderr)


def cmd_run_contest(args):
    """Salsify sender -> trace-emulated link -> receiver, in-process
    (scripts/run-contest with mahimahi shells, reproduced natively); the
    encoders and the receiver's decoder on --device."""
    import threading
    import time

    import numpy as np

    from alfalfa_tpu_torch.net.emulation import (EmulatedLink,
                                                 lte_like_trace,
                                                 load_mahimahi_trace)
    from alfalfa_tpu_torch.salsify import SalsifyReceiver, SalsifySender
    from alfalfa_tpu_torch.salsify.fake_webcam import Y4MInput
    from alfalfa_tpu_torch.util.y4m import Y4MReader

    rd = Y4MReader(args.input)
    W, H = rd.width, rd.height
    rd.close()
    trace = (load_mahimahi_trace(args.trace) if args.trace
             else lte_like_trace())
    received = []
    receiver = SalsifyReceiver(args.port, W, H, on_raster=received.append,
                               device=args.device)
    # --port 0: the port the system picked
    link = EmulatedLink(0, receiver.socket.getsockname()[1], trace,
                        delay_ms=args.delay, queue_limit=args.queue).start()
    rt = threading.Thread(
        target=lambda: receiver.run(timeout_ms=int(args.idle * 1000)),
        daemon=True)
    rt.start()

    sender = SalsifySender("127.0.0.1", link.listen_port, 1337,
                           Y4MInput(args.input, fps=args.fps),
                           mode=args.mode, drop_frames_while_busy=False,
                           device=args.device)
    t0 = time.monotonic()
    try:
        sender.run(max_frames=args.frames)
        deadline = time.monotonic() + 5
        while rt.is_alive() and time.monotonic() < deadline:
            rt.join(0.1)
    finally:
        sender.close()
        receiver.close()
        link.close()
    wall = time.monotonic() - t0
    sizes = [s for _, s, _, _, _ in sender.sent_log]
    print(f"sent {len(sender.sent_log)} frames, received {len(received)}, "
          f"wall {wall:.1f}s")
    if sizes:
        print(f"frame bytes: mean {np.mean(sizes):.0f} "
              f"min {min(sizes)} max {max(sizes)}")
    print(f"link: {link.stats}")


_MBMODE_NAMES = ["DC_PRED", "V_PRED", "H_PRED", "TM_PRED", "B_PRED",
                 "NEARESTMV", "NEARMV", "ZEROMV", "NEWMV", "SPLITMV"]
_BMODE_NAMES = ["B_DC_PRED", "B_TM_PRED", "B_VE_PRED", "B_HE_PRED",
                "B_LD_PRED", "B_RD_PRED", "B_VR_PRED", "B_VL_PRED",
                "B_HD_PRED", "B_HU_PRED", "LEFT4X4", "ABOVE4X4", "ZERO4X4",
                "NEW4X4"]
_REF_NAMES = ["CURRENT_FRAME", "LAST_FRAME", "GOLDEN_FRAME", "ALTREF_FRAME"]


def cmd_dissect(args):
    """Bitstream analyzer with the reference xc-dissect's detail
    (xc-dissect.cc:43-478): full header dump, -p probability-table
    updates, -m per-macroblock modes/MVs, -C coefficients, -f frame
    filter, -s initial state."""
    from alfalfa_tpu_torch.util.ivf import IVFReader
    from alfalfa_tpu_torch.bitstream.header import UncompressedChunk
    from alfalfa_tpu_torch.state.decoder_state import DecoderState
    from alfalfa_tpu_torch.decoder.parse import FrameParser
    from alfalfa_tpu_torch.bitstream import tables as T

    def kv(key, value, level=0):
        print(("  " * level + key + ":").ljust(25) + str(value))

    def print_prob_tables(header):
        print("[Probability Tables]")
        upd = header.token_prob_update
        for i in range(T.BLOCK_TYPES):
            for j in range(T.COEF_BANDS):
                for k in range(T.PREV_COEF_CONTEXTS):
                    row = "\t".join(
                        str(upd[(i, j, k, l)]) if (i, j, k, l) in upd
                        else "-" for l in range(T.ENTROPY_NODES))
                    print(f"[ {i}, {j}, {k} ] = {{ {row}\t }}")
        print()

    def print_header_common(h):
        kv("refresh_entropy_probs", h.refresh_entropy_probs)
        kv("update_segmentation", h.update_segmentation is not None)
        kv("filter_type", h.filter_type)
        kv("mode_lf_adjustments", h.mode_lf_adjustments_enabled)
        if h.mode_lf_adjustments_enabled:
            upd = h.mode_lf_adjustments
            kv("lf_delta_update", upd is not None, 1)
            if upd is not None:
                print("  " * 2 + "ref_update:".ljust(21)
                      + "".join(f"{('X' if v is None else v)!s:>6}"
                                for v in upd.ref_update))
                print("  " * 2 + "mode_update:".ljust(21)
                      + "".join(f"{('X' if v is None else v)!s:>6}"
                                for v in upd.mode_update))
        kv("loop_filter_level", h.loop_filter_level)
        kv("sharpness_level", h.sharpness_level)
        kv("mb_no_skip_coeff", h.prob_skip_false is not None)
        if h.prob_skip_false is not None:
            kv("prob_skip_false", h.prob_skip_false)

    def print_frame_header(h, key_frame):
        if key_frame:
            print("[Keyframe Header]")
            kv("color_space", h.color_space)
            kv("clamping_type", h.clamping_type)
            print_header_common(h)
        else:
            print("[Interframe Header]")
            print_header_common(h)
            kv("refresh_last", h.refresh_last)
            kv("refresh_golden_frame", h.refresh_golden_frame)
            kv("refresh_alternate_frame", h.refresh_alternate_frame)
            kv("prob_inter", h.prob_inter)
            kv("prob_last", h.prob_references_last)
            kv("prob_golden", h.prob_references_golden)
            kv("16x16_prob_update", h.intra_16x16_prob is not None)
            if h.intra_16x16_prob is not None:
                print("  16x16_prob:".ljust(25)
                      + "".join(f"{v:>6}" for v in h.intra_16x16_prob))
            kv("chroma_prob_update", h.intra_chroma_prob is not None)
            if h.intra_chroma_prob is not None:
                print("  chroma_prob:".ljust(25)
                      + "".join(f"{v:>6}" for v in h.intra_chroma_prob))
            cells = []
            for i in range(2):
                for j in range(T.MV_PROB_CNT):
                    v = h.mv_prob_update.get((i, j))
                    # the parsed dict stores effective probs (raw<<1 or 1)
                    cells.append("-" if v is None
                                 else str((v >> 1) if v > 1 else 0))
            print("mv_prob_update:".ljust(25) + "|".join(cells))
        print()

    def print_quantizer(qi):
        print("[Quantizer]")
        print(f"y_ac_qi = {qi.y_ac_qi}")
        for name, v in (("y_dc", qi.y_dc), ("y2_dc", qi.y2_dc),
                        ("y2_ac", qi.y2_ac), ("uv_dc", qi.uv_dc),
                        ("uv_ac", qi.uv_ac)):
            if v is not None:
                print(f"{name:<7} = {v}")
        print()

    def print_coeffs(co):
        if co.any():
            print(f"DCT coeffs: {{ {' '.join(str(int(x)) for x in co)} }}")
            print()
        else:
            print("ALL ZERO")

    def print_macroblocks(arrays, coefficients):
        print("[Macroblocks]")
        for r in range(arrays.mb_rows):
            for c in range(arrays.mb_cols):
                print(f"Macroblock [ {c}, {r} ]")
                print("<Y>")
                ym = int(arrays.ymode[r, c])
                inter = int(arrays.ref[r, c]) > 0
                print(f"Prediction Mode: {_MBMODE_NAMES[ym]}")
                if inter:
                    mv = arrays.sub_mv[r, c, 3, 3]
                    print(f"Base Motion Vector: ( {int(mv[0])}, "
                          f"{int(mv[1])} )")
                    print(f"Reference: {_REF_NAMES[int(arrays.ref[r, c])]}")
                print()
                for sr in range(4):
                    for sc in range(4):
                        print(f"Y Subblock [ {sc}, {sr} ]")
                        if ym in (T.B_PRED, T.SPLITMV):
                            bm = int(arrays.bmode[r, c, sr, sc])
                            print("Prediction Mode: "
                                  + _BMODE_NAMES[bm])
                        if coefficients:
                            print_coeffs(arrays.coeffs[r, c, sr * 4 + sc])
                if coefficients and arrays.y2_coded[r, c]:
                    print("<Y2>")
                    print_coeffs(arrays.coeffs[r, c, 24])
                    print()
                print()
                for plane, base in (("U", 16), ("V", 20)):
                    print(f"<{plane}>")
                    if not inter:
                        uv = int(arrays.uvmode[r, c])
                        print(f"Prediction Mode: {_MBMODE_NAMES[uv]}")
                    print()
                    for sr in range(2):
                        for sc in range(2):
                            print(f"{plane} Subblock [ {sc}, {sr} ]")
                            if coefficients:
                                print_coeffs(
                                    arrays.coeffs[r, c, base + sr * 2 + sc])
                print()

    if args.coeffs:
        args.macroblocks = True
    src = IVFReader(args.input)
    if args.initial_state:
        from alfalfa_tpu_torch.state import serdes
        state, _refs = serdes.load_decoder(args.initial_state, device="cpu")
    else:
        state = DecoderState.initial(src.width, src.height)
    for i, payload in enumerate(src):
        chunk = UncompressedChunk(payload, src.width, src.height)
        header, arrays, _ = FrameParser(state).parse(chunk)
        if args.frame is not None and i != args.frame:
            continue
        kind = "keyframe" if chunk.key_frame else "interframe"
        print(f"frame #{i}: {kind}, {len(payload)} bytes")
        if not chunk.show_frame:
            print("(hidden frame)")
        if not chunk.key_frame:
            # InterFrame::stats parity (reference frame.cc:350-373)
            total = arrays.ref.size
            inter_n = int((arrays.ref != T.CURRENT_FRAME).sum())
            print(f"\tPercentage Inter Coded: {inter_n * 100 / total}%")
            if inter_n:
                pct = [int((arrays.ref == rf).sum()) * 100 / inter_n
                       for rf in (T.LAST_FRAME, T.GOLDEN_FRAME,
                                  T.ALTREF_FRAME)]
                print(f"\tLast: {pct[0]}% Golden: {pct[1]}% "
                      f"Alternate: {pct[2]}%")
            updates = []
            if header.refresh_last:
                updates.append("last")
            if header.refresh_golden_frame:
                updates.append("golden")
            if header.refresh_alternate_frame:
                updates.append("alternate")
            if header.copy_buffer_to_golden:
                updates.append(f"golden<-copy{header.copy_buffer_to_golden}")
            if header.copy_buffer_to_alternate:
                updates.append(
                    f"alternate<-copy{header.copy_buffer_to_alternate}")
            print(f"\tReference Updates: {', '.join(updates) or 'none'}")
        if args.probability_tables:
            print_prob_tables(header)
        print_frame_header(header, chunk.key_frame)
        print_quantizer(header.quant_indices)
        if args.macroblocks:
            arrays.densify_coeffs()
            print_macroblocks(arrays, args.coeffs)


def main(argv=None):
    from alfalfa_tpu_torch.util import tracing

    parser = argparse.ArgumentParser(prog="xc", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--timings", action="store_true",
                        help="print per-stage timings to stderr")
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="write a torch.profiler Chrome trace to DIR")
    sub = parser.add_subparsers(dest="command", required=True)

    def device_arg(p):
        p.add_argument("--device", default="cuda",
                       help="torch device that reconstructs the frames")

    def decoder_args(p):
        p.add_argument("-s", "--state", default=None,
                       help="input decoder state")
        device_arg(p)

    p = sub.add_parser("decode", help="decode IVF to y4m")
    p.add_argument("input")
    p.add_argument("output")
    decoder_args(p)
    p.set_defaults(func=cmd_decode)

    p = sub.add_parser("decode-raw", help="decode IVF to raw YUV on stdout")
    p.add_argument("input")
    decoder_args(p)
    p.set_defaults(func=cmd_decode_raw)

    p = sub.add_parser("decode-bundle",
                       help="decode IVF sequence from stdin as one stream")
    p.add_argument("output")
    device_arg(p)
    p.set_defaults(func=cmd_decode_bundle)

    p = sub.add_parser("play", help="decode IVF and display live (vp8play)")
    p.add_argument("input")
    p.add_argument("-f", "--fullscreen", action="store_true")
    decoder_args(p)
    p.set_defaults(func=cmd_play)

    p = sub.add_parser("display-jpeg",
                       help="decode one JPEG and show it (display-jpeg)")
    p.add_argument("input")
    p.add_argument("-f", "--fullscreen", action="store_true")
    p.add_argument("-s", "--seconds", type=float, default=5.0,
                   help="how long to keep the window up")
    p.set_defaults(func=cmd_display_jpeg)

    p = sub.add_parser("webcam",
                       help="show live camera frames (real-webcam)")
    p.add_argument("-d", "--device", default="/dev/video0",
                   help="the camera's V4L2 device")
    p.add_argument("-p", "--pixfmt", default="NV12")
    p.add_argument("-f", "--fullscreen", action="store_true")
    p.set_defaults(func=cmd_webcam)

    p = sub.add_parser("enc", help="encode y4m/ivf to VP8 IVF")
    p.add_argument("input")
    p.add_argument("-o", "--output", default="output.ivf")
    p.add_argument("-i", "--input-format", default="y4m",
                   choices=["y4m", "ivf"])
    p.add_argument("-y", "--y-ac-qi", type=int, default=None,
                   help="constant quantizer index")
    p.add_argument("-s", "--ssim", type=float, default=None,
                   help="target SSIM (binary search per frame)")
    p.add_argument("-F", "--frame-sizes", default=None,
                   help="file of per-frame target sizes in bytes")
    p.add_argument("-q", "--quality", default="best", choices=["best", "rt"])
    p.add_argument("--two-pass", action="store_true",
                   help="second encoding pass with trellis quantization")
    p.add_argument("--fast", action="store_true",
                   help="fast interframe path (Salsify's); requires -q rt")
    p.add_argument("-O", "--output-state", default=None,
                   help="write final encoder state")
    p.add_argument("-I", "--input-state", default=None,
                   help="initial encoder state")
    p.add_argument("-r", "--reencode", action="store_true",
                   help="rebase mode: reuse modes/MVs from --pred-ivf")
    p.add_argument("-p", "--pred-ivf", default=None,
                   help="prediction modes IVF (rebase mode)")
    p.add_argument("-S", "--pred-state", default=None,
                   help="prediction IVF initial state")
    p.add_argument("-w", "--kf-q-weight", type=float, default=1.0)
    p.add_argument("-e", "--extra-frame-chunk", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device that encodes the frames")
    p.set_defaults(func=cmd_enc)

    p = sub.add_parser("enc-parallel",
                       help="parallel chunk encode + serial rebase (ExCamera)")
    p.add_argument("input", help="y4m input")
    p.add_argument("-o", "--output", default="output.ivf")
    p.add_argument("-y", "--y-ac-qi", type=int, default=None)
    p.add_argument("-s", "--ssim", type=float, default=None)
    p.add_argument("-q", "--quality", default="best", choices=["best", "rt"])
    p.add_argument("--two-pass", action="store_true")
    p.add_argument("-c", "--chunk-frames", type=int, default=6)
    p.add_argument("-j", "--workers", type=int, default=None)
    p.add_argument("-w", "--kf-q-weight", type=float, default=0.5)
    p.add_argument("--device", default="cuda",
                   help="torch device of the chunk encoders and the rebase")
    p.set_defaults(func=cmd_enc_parallel)

    p = sub.add_parser("terminate-chunk",
                       help="rewrite last interframe to refresh all references")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("output_state", nargs="?", default=None,
                   help="write the terminated stream's exit decoder state")
    p.add_argument("-O", "--output-state", dest="output_state_opt",
                   default=None, help="same as the positional operand")
    device_arg(p)
    p.set_defaults(func=cmd_terminate_chunk)

    p = sub.add_parser("dump", help="decode frame N, dump decoder state")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-f", "--frame-number", type=int, default=None)
    device_arg(p)
    p.set_defaults(func=cmd_dump)

    p = sub.add_parser("diff", help="structural diff of two state files")
    p.add_argument("first")
    p.add_argument("second")
    p.set_defaults(func=cmd_diff)

    p = sub.add_parser("comp-states", help="bit-level state comparison")
    p.add_argument("first")
    p.add_argument("second")
    p.set_defaults(func=cmd_comp_states)

    p = sub.add_parser("ssim", help="frame-by-frame SSIM of two videos")
    p.add_argument("first")
    p.add_argument("second")
    device_arg(p)
    p.set_defaults(func=cmd_ssim)

    p = sub.add_parser("framesize", help="print per-frame compressed sizes")
    p.add_argument("input")
    p.set_defaults(func=cmd_framesize)

    p = sub.add_parser("merge", help="concatenate IVF files")
    p.add_argument("inputs", nargs="+")
    p.add_argument("-o", "--output", required=True)
    p.set_defaults(func=cmd_merge)

    p = sub.add_parser("zero-out-residues",
                       help="zero residues, keep modes/MVs")
    p.add_argument("input")
    p.add_argument("output")
    p.set_defaults(func=cmd_zero_out_residues)

    p = sub.add_parser("dissect", help="bitstream analyzer")
    p.add_argument("input")
    p.add_argument("-m", "--macroblocks", action="store_true")
    p.add_argument("-p", "--probability-tables", action="store_true",
                   help="print the prob-table updates for each frame")
    p.add_argument("-C", "-c", "--coeffs", action="store_true",
                   help="dump coefficient blocks (implies -m)")
    p.add_argument("-f", "--frame", type=int, default=None,
                   help="print information for frame #<arg> only")
    p.add_argument("-s", "--initial-state", default=None,
                   help="decoder initial state file")
    p.set_defaults(func=cmd_dissect)

    p = sub.add_parser("run-contest",
                       help="salsify over an emulated cellular link "
                            "(scripts/run-contest)")
    p.add_argument("input", help="y4m input clip")
    p.add_argument("--trace", help="mahimahi delivery trace file "
                                   "(default: synthetic LTE-like)")
    p.add_argument("--delay", type=int, default=20,
                   help="one-way propagation delay ms")
    p.add_argument("--queue", type=int, default=64,
                   help="drop-tail queue limit (packets)")
    p.add_argument("--fps", type=int, default=None, help="pace input at fps")
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--mode", default="s2",
                   choices=["s1", "s2", "conventional"])
    p.add_argument("--port", type=int, default=0,
                   help="receiver's UDP port (0: any free port)")
    p.add_argument("--idle", type=float, default=10.0,
                   help="receiver idle timeout (s)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the encoders and the decoder")
    p.set_defaults(func=cmd_run_contest)

    args = parser.parse_args(argv)
    was_tracing = tracing.enabled()
    if args.timings:
        tracing.enable()
    try:
        with tracing.profile(args.profile):
            return args.func(args)
    finally:
        if args.timings:
            tracing.report()
            tracing.enable(was_tracing)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        sys.exit(0)
