"""`xc` - the command line of the port (mirrors the reference's frontend
programs).  So far:

  decode        IVF -> y4m (vp8decode, incl. -s input state)
  decode-raw    IVF -> raw planar YUV on stdout (decode-to-stdout)

Frames are reconstructed on ``--device`` (default ``cuda``; ``cpu`` runs
the kernels' plain versions).  Run from the repository root:

    python -m alfalfa_tpu_torch.cli.xc decode-raw in.ivf > out.yuv
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

    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        sys.exit(0)
