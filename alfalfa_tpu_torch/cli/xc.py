"""`xc` - the command line of the port (mirrors the reference's frontend
programs).  So far:

  decode        IVF -> y4m (vp8decode, incl. -s input state)
  decode-raw    IVF -> raw planar YUV on stdout (decode-to-stdout)
  enc           y4m / IVF -> VP8 IVF (xc-enc: constant quantizer, minimum
                SSIM or target sizes; -I / -O encoder state files; --fast:
                rt interframes through the fast path)

Frames are reconstructed and encoded on ``--device`` (default ``cuda``;
``cpu`` runs the kernels' plain versions).  Run from the repository root:

    python -m alfalfa_tpu_torch.cli.xc decode-raw in.ivf > out.yuv
    python -m alfalfa_tpu_torch.cli.xc enc -o out.ivf --y-ac-qi 48 in.y4m
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
    p.add_argument("--device", default="cuda",
                   help="torch device that encodes the frames")
    p.set_defaults(func=cmd_enc)

    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        sys.exit(0)
