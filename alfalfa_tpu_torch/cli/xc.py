"""`xc` - the command line of the port (mirrors the reference's frontend
programs).  So far:

  decode        IVF -> y4m (vp8decode, incl. -s input state)
  decode-raw    IVF -> raw planar YUV on stdout (decode-to-stdout)
  enc           y4m / IVF -> VP8 IVF (xc-enc: constant quantizer, minimum
                SSIM or target sizes; -I / -O encoder state files; --fast:
                rt interframes through the fast path; -r: the rebase of a
                prediction IVF against -I's state, ExCamera's)
  enc-parallel  y4m -> VP8 IVF by parallel chunk encodes and the serial
                rebase (ExCamera's cluster encode)

Frames are reconstructed and encoded on ``--device`` (default ``cuda``;
``cpu`` runs the kernels' plain versions).  Run from the repository root:

    python -m alfalfa_tpu_torch.cli.xc decode-raw in.ivf > out.yuv
    python -m alfalfa_tpu_torch.cli.xc enc -o out.ivf --y-ac-qi 48 in.y4m
    python -m alfalfa_tpu_torch.cli.xc enc -r -I prev.state -p pred.ivf \
        -o rebased.ivf in.y4m
    python -m alfalfa_tpu_torch.cli.xc enc-parallel -y 48 -c 6 -j 4 \
        -o out.ivf in.y4m
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


def main(argv=None):
    parser = argparse.ArgumentParser(prog="xc", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    def decoder_args(p):
        p.add_argument("-s", "--state", default=None,
                       help="input decoder state")
        p.add_argument("--device", default="cuda",
                       help="torch device that reconstructs the frames")

    p = sub.add_parser("decode", help="decode IVF to y4m")
    p.add_argument("input")
    p.add_argument("output")
    decoder_args(p)
    p.set_defaults(func=cmd_decode)

    p = sub.add_parser("decode-raw", help="decode IVF to raw YUV on stdout")
    p.add_argument("input")
    decoder_args(p)
    p.set_defaults(func=cmd_decode_raw)

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

    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        sys.exit(0)
