"""ExCamera's command-line toolchain in the port (``xc terminate-chunk``,
``dump``, ``diff``, ``comp-states``, ``merge``, ``framesize``,
``decode-bundle``, ``ssim``, ``zero-out-residues``, ``dissect``, ``play``,
``display-jpeg``, ``webcam``, and the ``--timings`` / ``--profile``
flags) against the JAX package's CLI on the CPU, tolerance 0: every file,
state file, stdout and exit code byte-equal.

- the chunk workflow on a 64x48 clip: chunks encoded with ``xc enc``,
  chunk 0 terminated with its exit state, dumped and compared, the next
  chunk rebased onto the terminated state, merged, sized, decoded as a
  bundle and scored;
- the stream tools on the fixtures whose headers carry key frames,
  segmentation, loop-filter deltas, probability updates and rt / two-pass
  streams, and on the authored feature streams; the port's serializer is
  the identity on every frame the parser yields;
- the global flags, and the display commands, which fail where the JAX
  package's fail (no display here; OpenCV may be missing elsewhere).

On the card, chip_smoke.py's ``xc_tools`` phase runs the chunk workflow
at 720p against digests the slow test below recomputes with the JAX CLI.
"""
import contextlib
import hashlib
import io
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)    # many tiny ops: threads only add contention

from alfalfa_tpu.cli import xc as jxc                    # noqa: E402

from alfalfa_tpu_torch.bitstream.header import UncompressedChunk  # noqa: E402
from alfalfa_tpu_torch.cli import xc                     # noqa: E402
from alfalfa_tpu_torch.decoder.parse import FrameParser  # noqa: E402
from alfalfa_tpu_torch.encoder.serializer import serialize_frame  # noqa: E402
from alfalfa_tpu_torch.state.decoder_state import DecoderState  # noqa: E402
from alfalfa_tpu_torch.util.ivf import IVFReader         # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures"
sys.path.insert(0, str(FIXTURES))
from gen_inputs import gen_clip, write_y4m  # noqa: E402
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

# the port on the CPU: the decoding commands' device
CPU = ["--device", "cpu"]


def run_xc(main, argv, stdin=None):
    """``main(argv)`` in this process: (exit code, stdout text)."""
    out = io.StringIO()
    saved = sys.stdin
    if stdin is not None:
        sys.stdin = io.StringIO(stdin)
    try:
        with contextlib.redirect_stdout(out):
            try:
                rc = main(argv)
            except SystemExit as e:
                rc = e.code
    finally:
        sys.stdin = saved
    return rc or 0, out.getvalue()


def chunk_workflow(main, d, dev, qi=48):
    """ExCamera's chunk workflow through ``main`` in directory ``d``,
    which holds c0.y4m (chunk 0), c1.y4m (chunk 1) and all.y4m (both):
    the two chunks encoded at ``qi``; chunk 0 terminated with its exit
    state, dumped after its last frame and after its first, the states
    compared (with the encoder's); chunk 1 rebased onto the
    terminated state; merged and sized; decoded as a bundle and as one
    file; scored against all.y4m; chunk 1's own encode with its residues
    zeroed and dissected, and the rebased chunk dissected from the
    terminated state.  ``dev``: the arguments of a decoding command.
    Returns {command: (exit code, stdout)} and the files written, as
    {name: bytes}."""
    f = lambda n: str(d / n)
    res = {}

    def run(key, argv, stdin=None):
        res[key] = run_xc(main, argv, stdin)

    run("enc c0", ["enc", f("c0.y4m"), "-y", str(qi), "-o", f("c0.ivf"),
                   "-O", f("c0.state")] + dev)
    run("enc pred", ["enc", f("c1.y4m"), "-y", str(qi), "-o", f("pred.ivf")]
        + dev)
    run("terminate-chunk", ["terminate-chunk", f("c0.ivf"), f("c0t.ivf"),
                            "-O", f("c0t.state")] + dev)
    run("dump", ["dump", f("c0t.ivf"), f("dump.state")] + dev)
    run("dump -f 0", ["dump", f("c0t.ivf"), f("dump0.state"), "-f", "0"]
        + dev)
    for a, b in (("dump", "c0t"), ("c0", "c0t"), ("dump0", "c0t")):
        for cmd in ("diff", "comp-states"):
            run(f"{cmd} {a} {b}", [cmd, f(a + ".state"), f(b + ".state")])
    run("enc -r", ["enc", f("c1.y4m"), "-r", "-I", f("c0t.state"), "-p",
                   f("pred.ivf"), "-w", "0.5", "-o", f("rebased.ivf")] + dev)
    run("merge", ["merge", f("c0t.ivf"), f("rebased.ivf"), "-o",
                  f("merged.ivf")])
    run("framesize", ["framesize", f("merged.ivf")])
    run("decode-bundle", ["decode-bundle", f("bundle.y4m")] + dev,
        stdin=f("c0t.ivf") + "\n" + f("rebased.ivf") + "\n")
    run("decode", ["decode", f("merged.ivf"), f("merged.y4m")] + dev)
    run("ssim", ["ssim", f("merged.ivf"), f("all.y4m")] + dev)
    run("zero-out-residues", ["zero-out-residues", f("pred.ivf"),
                              f("zero.ivf")])
    run("decode zero", ["decode", f("zero.ivf"), f("zero.y4m")] + dev)
    run("dissect pred", ["dissect", "-m", "-p", "-C", "-f", "1",
                         f("pred.ivf")])
    run("dissect rebased", ["dissect", "-s", f("c0t.state"), "-f", "0",
                            f("rebased.ivf")])
    files = {n: (d / n).read_bytes() for n in (
        "c0.ivf", "c0.state", "pred.ivf", "c0t.ivf", "c0t.state",
        "dump.state", "dump0.state", "rebased.ivf", "merged.ivf", "bundle.y4m",
        "merged.y4m", "zero.ivf", "zero.y4m")}
    return res, files


def write_chunks(d, clip, w, h, n0):
    write_y4m(str(d / "c0.y4m"), clip[:n0], w, h)
    write_y4m(str(d / "c1.y4m"), clip[n0:], w, h)
    write_y4m(str(d / "all.y4m"), clip, w, h)


def test_excamera_chunk_tools_match_jax(tmp_path):
    """The chunk workflow at 64x48 (six frames, chunks of three) through
    the JAX CLI and the port's ``main([... "--device", "cpu"])``: every
    file, state, stdout and exit code byte-equal, and the workflow's own
    checks hold (the dump equals the terminated state, the bundle equals
    the merged file's decode)."""
    w, h = 64, 48
    clip = gen_clip(w, h, 6, seed=45)
    got = {}
    for name, main, dev in (("jax", jxc.main, []), ("port", xc.main, CPU)):
        d = tmp_path / name
        d.mkdir()
        write_chunks(d, clip, w, h, 3)
        got[name] = chunk_workflow(main, d, dev)
    (jres, jfiles), (pres, pfiles) = got["jax"], got["port"]
    for key in jres:
        assert pres[key] == jres[key], key
    for name in jfiles:
        assert pfiles[name] == jfiles[name], name
    assert pfiles["dump.state"] == pfiles["c0t.state"]
    assert pfiles["bundle.y4m"] == pfiles["merged.y4m"]
    assert pres["diff dump c0t"] == (0, "states are identical\n")
    assert pres["comp-states dump c0t"] == (0, "0 bits differ\n")
    assert pres["diff dump0 c0t"][0] == 1
    assert pres["comp-states dump0 c0t"][0] == 1
    assert pres["framesize"][1].split() == \
        [str(len(p)) for p in IVFReader(str(tmp_path / "port" / "merged.ivf"))]
    assert len(pres["ssim"][1].splitlines()) == 6


STREAM_FIXTURES = ["kf_64x48_q40", "inter_176x144_rt_q48", "inter_176x144_q8",
                   "twopass_176x144_q32"]
FEATURE_STREAMS = ["segmentation", "goldalt", "probs", "splitmv"]


def _stream_commands(src, o, state):
    return [(["zero-out-residues", src, o + "z.ivf"], [o + "z.ivf"]),
            (["terminate-chunk", src, o + "t.ivf", o + "t.state"],
             [o + "t.ivf", o + "t.state"]),
            (["framesize", src], []),
            (["dissect", "-m", "-p", "-C", src], []),
            (["dissect", "-f", "1", src], []),
            (["dissect", "-s", state, "-f", "2", "-m", src], [])]


def test_stream_tools_match_jax(tmp_path):
    """``zero-out-residues``, ``terminate-chunk`` (its exit state decoded
    by the port on the CPU), ``framesize`` and ``dissect`` (``-m -p -C``,
    ``-f``, ``-s`` with a 176x144 state file) on four fixtures and four
    authored feature streams (SPLITMV, segmentation maps, golden and
    alternate references with copies and sign bias, probability updates
    that persist): outputs byte-equal to the JAX CLI's.  Every frame of
    each stream parses and re-serializes through the port to its own
    bytes.  The port's generator (``tools/feature_streams.py``, its key
    frames on the CPU) writes each feature stream's bytes."""
    import gen_feature_streams as G
    from alfalfa_tpu_torch.tools import feature_streams
    streams = [str(FIXTURES / (n + ".ivf")) for n in STREAM_FIXTURES]
    for name in FEATURE_STREAMS:
        path = str(tmp_path / (name + ".ivf"))
        getattr(G, "gen_" + name)(path)
        streams.append(path)
        ported = str(tmp_path / (name + "_port.ivf"))
        getattr(feature_streams, "gen_" + name)(ported, device="cpu")
        with open(path, "rb") as want, open(ported, "rb") as got:
            assert got.read() == want.read(), name
    state = str(FIXTURES / "dump_frame5.state")
    for src in streams:
        ivf = IVFReader(src)
        parse_state = DecoderState.initial(ivf.width, ivf.height)
        for i, payload in enumerate(ivf):
            chunk = UncompressedChunk(payload, ivf.width, ivf.height)
            header, arrays, probs = FrameParser(parse_state).parse(chunk)
            assert serialize_frame(header, arrays, probs, chunk.key_frame,
                                   ivf.width, ivf.height,
                                   chunk.show_frame) == payload, (src, i)
        stem = os.path.basename(src)
        for argv, outs in _stream_commands(src, str(tmp_path / stem), state):
            if "-s" in argv and (ivf.width, ivf.height) != (176, 144):
                continue
            sides = []
            for main, dev in ((jxc.main, []), (xc.main, CPU)):
                extra = dev if argv[0] == "terminate-chunk" else []
                rc, text = run_xc(main, argv + extra)
                sides.append((rc, text, [open(p, "rb").read() for p in outs]))
            assert sides[1] == sides[0], (stem, argv)


def _subprocess_failure(module, argv, dev):
    """Run ``python -m module argv`` headless: (exit code, its last line
    of stderr)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("DISPLAY", None)
    env.pop("WAYLAND_DISPLAY", None)
    r = subprocess.run([sys.executable, "-m", module] + argv + dev, cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)
    lines = [l for l in r.stderr.splitlines() if l.strip()]
    return r.returncode, lines[-1] if lines else ""


def test_cli_flags_and_display_match_jax(tmp_path):
    """``--timings`` prints the JAX CLI's stage report on stderr, the
    port's with each span's self time beside its total; ``--profile DIR``
    writes a Chrome trace there and names it; ``play``,
    ``display-jpeg`` and ``webcam`` are registered and, on a host without
    a display (or without OpenCV), fail as the JAX CLI's do: the same exit
    code and the same last line of stderr."""
    src = str(FIXTURES / "kf_64x48_q40.ivf")
    jax_line = re.compile(r"^  (\S+) +total +[0-9.]+ ms   n +[0-9]+   "
                          r"mean +[0-9.]+ ms$")
    port_line = re.compile(r"^  (\S+) +total +[0-9.]+ ms   self +[0-9.]+ ms"
                           r"   n +[0-9]+   mean +[0-9.]+ ms$")
    reports = []
    for main, dev, line in ((jxc.main, [], jax_line),
                            (xc.main, CPU, port_line)):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            assert run_xc(main, ["--timings", "decode", src,
                                 str(tmp_path / "t.y4m")] + dev)[0] == 0
        text = err.getvalue().splitlines()
        start = text.index("-- stage timings --")
        end = (text.index("-- counters --") if "-- counters --" in text
               else len(text))
        stages = [line.match(l) for l in text[start + 1:end]]
        assert stages and all(stages), text
        reports.append({m.group(1) for m in stages})
    assert "decode.parse" in reports[0] & reports[1]

    trace_dir = tmp_path / "trace"
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert run_xc(xc.main, ["--profile", str(trace_dir), "decode", src,
                                str(tmp_path / "p.y4m")] + CPU)[0] == 0
    files = list(trace_dir.iterdir())
    assert len(files) == 1 and str(files[0]) in err.getvalue()
    assert json.loads(files[0].read_text())["traceEvents"]

    from PIL import Image
    jpeg = tmp_path / "f.jpg"
    Image.new("RGB", (64, 48), (90, 140, 200)).save(jpeg)
    cases = [(["play", src], CPU), (["display-jpeg", str(jpeg), "-s", "0"], []),
             (["webcam", "-d", str(tmp_path / "no-camera")], [])]
    for argv, dev in cases:
        want = _subprocess_failure("alfalfa_tpu.cli.xc", argv, [])
        got = _subprocess_failure("alfalfa_tpu_torch.cli.xc", argv, dev)
        assert want[0] != 0 and got == want, (argv, got, want)


# ---------------------------------------------------------------- slow

# chunk_workflow's commands whose stdout chip_smoke.py holds to a digest,
# under chip_smoke.XC_TOOLS_TEXT_SHA1's names
TEXT_KEYS = {"diff c0 c0t": "diff encoder terminated",
             "comp-states c0 c0t": "comp-states encoder terminated",
             "diff dump0 c0t": "diff frame0 terminated",
             "comp-states dump0 c0t": "comp-states frame0 terminated",
             "ssim": "ssim", "dissect pred": "dissect pred",
             "dissect rebased": "dissect rebased"}


def _digest_workflow(res, files):
    """What chip_smoke.py's xc_tools phase holds the port to: SHA-1 of each
    frame of the terminated, rebased and zeroed chunks and of the merged
    stream, of the decoded zeroed chunk, and of the state comparisons',
    ssim's and dissect's stdout with their exit codes."""
    sha = lambda b: hashlib.sha1(b).hexdigest()
    frames = lambda n: [sha(p) for p in IVFReader(files[n])]
    return {
        "terminated": frames("c0t.ivf"), "rebased": frames("rebased.ivf"),
        "merged": frames("merged.ivf"), "zero": frames("zero.ivf"),
        "zero_decoded": sha(files["zero.y4m"]),
        "text": {name: [res[k][0], sha(res[k][1].encode())]
                 for k, name in TEXT_KEYS.items()}}


@pytest.mark.slow
def test_chip_smoke_xc_tools_digests_from_jax(tmp_path):
    """chip_smoke.XC_TOOLS_*, recomputed with the JAX CLI: its FilePlayer
    decodes frames 0-5 of the 720p fixture, and the chunk workflow runs
    through its main() on chunks of three at qi 48.  Also holds the terminated and rebased chunks to CLUSTER_SHA1.  About
    three minutes of CPU."""
    from alfalfa_tpu.decoder.decoder import FilePlayer as JFilePlayer
    import numpy as np
    frames = []
    for raster in JFilePlayer(str(FIXTURES / "inter_1280x720_q48.ivf")):
        frames.append(tuple(np.array(p) for p in raster.display()))
        if len(frames) == chip_smoke.REBASE_FRAMES:
            break
    write_chunks(tmp_path, frames, 1280, 720, chip_smoke.REBASE_CHUNK)
    res, files = chunk_workflow(jxc.main, tmp_path, [], chip_smoke.REBASE_QI)
    got = _digest_workflow(res, files)
    assert got["terminated"] + got["rebased"] == chip_smoke.CLUSTER_SHA1
    assert got["merged"] == chip_smoke.CLUSTER_SHA1
    assert files["dump.state"] == files["c0t.state"]
    assert got["zero"] == chip_smoke.XC_TOOLS_ZERO_SHA1
    assert got["zero_decoded"] == chip_smoke.XC_TOOLS_ZERO_DECODED_SHA1
    assert got["text"] == chip_smoke.XC_TOOLS_TEXT_SHA1
