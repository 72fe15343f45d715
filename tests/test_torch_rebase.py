"""The rebase slice on the CPU, tolerance 0: ExCamera's rebase (``xc enc
-r``) and cluster encode (``xc enc-parallel``) in the port, on
``device="cpu"`` (so K3, K5, K8 and the residue kernel run their plain
versions), against the JAX package:

- the inter residue update's plain version (K3's plain version, then
  ``ops.rebase.inter_residues_plain``) against the JAX package's
  ``reencode_device._fn_core`` under one ``jax.jit``: coefficients, nonzero
  flags and reconstruction equal at inter macroblocks, intra ones
  untouched, over quantizers 0-127 with and without per-component
  deltas, whole-vector, SPLITMV, mixed and extreme-vector macroblocks, at
  80x48 and 176x144;
- the residue kernel's plain version of a whole frame
  (``ops.rebase.rebase_frame_plain``: the inter macroblocks as above, the
  intra ones with their given modes) against the JAX package's host
  ``update_residues`` on seeded prediction frames holding every whole
  luma mode, B_PRED, every chroma mode, whole-vector and SPLITMV
  macroblocks, at 80x48 and 176x144: coefficients, flags and
  reconstruction equal; the wrapper's CPU route and argument checks;
- the port's ``reencode`` byte-identical to the JAX host ``reencode`` at
  80x48 (a leading key frame at two key-frame weights, an extra-frame
  chunk, an interior key frame), on prediction frames holding B_PRED,
  whole-mode intra and SPLITMV macroblocks; every rebased frame
  re-decodes to the encoder's minihash;
- ``parallel_encode`` against the JAX package's at 64x48, one worker and
  three worker processes;
- ``xc enc -r`` and ``xc enc-parallel`` through the port's ``main()``
  against the JAX CLI, state files included.

On the card, chip_smoke.py holds the residue kernel against its plain
version and the 720p rebase and cluster encode against REBASE_SHA1 and
CLUSTER_SHA1, which the slow test below recomputes with the JAX package.
"""
import functools
import hashlib
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)    # many tiny ops: threads only add contention

import jax                                               # noqa: E402
import jax.numpy as jnp                                  # noqa: E402

from alfalfa_tpu.bitstream.header import \
    UncompressedChunk as JUncompressedChunk              # noqa: E402
from alfalfa_tpu.cli import xc as jxc                    # noqa: E402
from alfalfa_tpu.bitstream.header import \
    InterFrameHeader as JInterFrameHeader                # noqa: E402
from alfalfa_tpu.bitstream.header import \
    QuantIndices as JQuantIndices                        # noqa: E402
from alfalfa_tpu.decoder.parse import FrameArrays as JFrameArrays  # noqa: E402
from alfalfa_tpu.decoder.parse import FrameParser as JFrameParser  # noqa: E402
from alfalfa_tpu.encoder import Encoder as JEncoder      # noqa: E402
from alfalfa_tpu.encoder import reencode as JRB          # noqa: E402
from alfalfa_tpu.encoder import reencode_device as JRD   # noqa: E402
from alfalfa_tpu.parallel.cluster import \
    parallel_encode as jparallel_encode                  # noqa: E402
from alfalfa_tpu.state import serdes as jserdes          # noqa: E402
from alfalfa_tpu.state.decoder_state import \
    DecoderState as JDecoderState                        # noqa: E402
from alfalfa_tpu.state.decoder_state import Raster as JRaster  # noqa: E402
from alfalfa_tpu.state.decoder_state import \
    References as JReferences                            # noqa: E402
from alfalfa_tpu.util.ivf import IVFWriter as JIVFWriter  # noqa: E402

from alfalfa_tpu_torch.bitstream import tables as T      # noqa: E402
from alfalfa_tpu_torch.bitstream.header import QuantIndices  # noqa: E402
from alfalfa_tpu_torch.cli import xc                     # noqa: E402
from alfalfa_tpu_torch.decoder import Decoder            # noqa: E402
from alfalfa_tpu_torch.decoder.parse import luma_to_chroma  # noqa: E402
from alfalfa_tpu_torch.encoder import Encoder            # noqa: E402
from alfalfa_tpu_torch.encoder import reencode as RB     # noqa: E402
from alfalfa_tpu_torch.encoder.encode_intra import QUANT_KEYS  # noqa: E402
from alfalfa_tpu_torch.ops import rebase, rebase_cuda    # noqa: E402
from alfalfa_tpu_torch.ops.sixtap import mc_planes_plain  # noqa: E402
from alfalfa_tpu_torch.parallel.cluster import parallel_encode  # noqa: E402
from alfalfa_tpu_torch.state import serdes               # noqa: E402
from alfalfa_tpu_torch.util.ivf import IVFReader, IVFWriter  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures"
sys.path.insert(0, str(FIXTURES))
from gen_inputs import gen_clip, write_y4m  # noqa: E402
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402


# ------------------------------------------- (a) the residue update alone

@functools.lru_cache(maxsize=None)
def _jax_fn_core(R, C):
    """The JAX package's per-frame residue update, one jit per shape."""
    return jax.jit(JRD._fn_core(R, C))


def _residue_inputs(kind, width, height, seed):
    """Seeded references, originals and per-macroblock maps.  ``kind``:
    "whole" (every macroblock inter, one vector each), "splitmv" (every
    macroblock SPLITMV, a vector a 4x4 block), "mixed" (intra positions
    among both) or "extreme" (mixed, vectors far outside the frame)."""
    R, C = height // 16, width // 16
    rng = np.random.default_rng(seed)
    shapes = [(height, width), (height // 2, width // 2),
              (height // 2, width // 2)]
    refs = [rng.integers(0, 256, (3,) + s, dtype=np.uint8) for s in shapes]
    # originals near the references, so that quantized residues vary
    orig = [np.clip(r[0].astype(int) + rng.integers(-40, 41, r[0].shape),
                    0, 255).astype(np.uint8) for r in refs]
    lo = 1 if kind in ("whole", "splitmv") else 0
    ref_sel = rng.integers(lo, 4, (R, C)).astype(np.int32)
    if not lo:
        ref_sel[0, 0] = T.CURRENT_FRAME     # a mix holds an intra macroblock
    if kind == "whole":
        splitmv = np.zeros((R, C), bool)
    elif kind == "splitmv":
        splitmv = np.ones((R, C), bool)
    else:
        splitmv = rng.random((R, C)) < 0.5
    span = 8 * (width + 64) if kind == "extreme" else 40
    sub_mv = rng.integers(-span, span + 1, (R, C, 4, 4, 2)).astype(np.int32)
    whole = ~splitmv
    sub_mv[whole] = sub_mv[whole][:, 3:4, 3:4]
    uv_mv = np.zeros((R, C, 2, 2, 2), np.int32)
    for r in range(R):
        for c in range(C):
            for ur in range(2):
                for uc in range(2):
                    uv_mv[r, c, ur, uc] = luma_to_chroma(*(
                        tuple(sub_mv[r, c, ur * 2 + a, uc * 2 + b])
                        for a in (0, 1) for b in (0, 1)))
    return refs, orig, ref_sel, splitmv, sub_mv, uv_mv


def _port_residues(refs, orig, ref_sel, splitmv, sub_mv, uv_mv, q):
    """K3's plain version, then the residue update's: (coefficients,
    nonzero, reconstructed planes), the planes zeroed before."""
    t = torch.from_numpy
    slots = {p: tuple(t(r)) for p, r in zip("yuv", refs)}
    pred = mc_planes_plain(slots, t(ref_sel)[None], t(sub_mv)[None],
                           t(uv_mv)[None])
    recon = [torch.zeros(o.shape, dtype=torch.uint8) for o in orig]
    co, nz = rebase.inter_residues_plain(
        [t(o) for o in orig], [p[0] for p in pred], t(ref_sel),
        t(splitmv), [q[k] for k in QUANT_KEYS], recon)
    return co.numpy(), nz.numpy(), [p.numpy() for p in recon]


# the per-component index deltas a prediction frame's header may carry
# (y_dc, y2_dc, y2_ac, uv_dc, uv_ac; 4-bit signed), which the rebase
# quantizes with as they are
DELTAS = {"no_deltas": {}, "deltas": dict(y_dc=5, y2_dc=-4, y2_ac=7,
                                          uv_dc=-6, uv_ac=3)}


@pytest.mark.parametrize("deltas", list(DELTAS))
@pytest.mark.parametrize("size", [(80, 48), (176, 144)],
                         ids=["80x48", "176x144"])
@pytest.mark.parametrize("kind", ["whole", "splitmv", "mixed", "extreme"])
@pytest.mark.parametrize("qi", [0, 4, 24, 48, 72, 100, 127])
def test_inter_residues_plain_equals_fn_core(qi, kind, size, deltas):
    """The plain residue update (behind K3's plain version) against the
    JAX package's _fn_core: equal at every inter macroblock, zero
    coefficients and flags and an untouched reconstruction at intra
    ones."""
    width, height = size
    R, C = height // 16, width // 16
    seed = qi * 31 + len(kind) * 7 + width + len(deltas)
    refs, orig, ref_sel, splitmv, sub_mv, uv_mv = _residue_inputs(
        kind, width, height, seed)
    q = {k: int(v) for k, v in QuantIndices(
        y_ac_qi=qi, **DELTAS[deltas]).quantizer().items()}

    def tiles(p, S):
        return jnp.asarray(np.ascontiguousarray(
            p.reshape(R, S, C, S).transpose(0, 2, 1, 3)))

    stacks = [jnp.asarray(np.stack([r[0], r[0], r[1], r[2]])) for r in refs]
    qs = np.array([q[k] for k in QUANT_KEYS] + [0, 0], np.int32)
    inter = ref_sel != T.CURRENT_FRAME
    want = _jax_fn_core(R, C)(
        tiles(orig[0], 16), tiles(orig[1], 8), tiles(orig[2], 8), *stacks,
        jnp.asarray(ref_sel), jnp.asarray(sub_mv), jnp.asarray(uv_mv),
        jnp.asarray(splitmv & inter), jnp.asarray(qs))
    w_co = np.asarray(want[0]).reshape(R, C, 25, 16)
    w_nz = np.asarray(want[2]).reshape(R, C)

    co, nz, recon = _port_residues(refs, orig, ref_sel, splitmv, sub_mv,
                                   uv_mv, q)
    np.testing.assert_array_equal(co[inter], w_co[inter])
    np.testing.assert_array_equal(nz[inter], w_nz[inter])
    assert not co[~inter].any() and not nz[~inter].any()
    for plane, w_rec, S in zip(recon, want[3:], (16, 8, 8)):
        t = plane.reshape(R, S, C, S).transpose(0, 2, 1, 3)
        np.testing.assert_array_equal(t[inter], np.asarray(w_rec)[inter])
        assert not t[~inter].any()
    assert (~inter).any() == (kind in ("mixed", "extreme"))
    assert nz[inter].any()


def _frame_inputs(width, height, seed):
    """Seeded references and originals (as _residue_inputs makes them) and
    a prediction frame's modes and vectors, a JAX FrameArrays: about half
    the macroblocks intra, their luma modes cycling DC, V, H, TM, B_PRED
    (random b-modes) and their chroma modes DC, V, H, TM, so that every
    pair comes round; the inter ones from a random slot, a third of them
    SPLITMV (a vector a 4x4 block), the rest one vector, up to 8 pixels
    out."""
    R, C = height // 16, width // 16
    refs, orig = _residue_inputs("mixed", width, height, seed)[:2]
    rng = np.random.default_rng(seed + 1)
    a = JFrameArrays(R, C)
    k = 0
    for r in range(R):
        for c in range(C):
            if rng.random() < 0.5:
                a.ymode[r, c], a.uvmode[r, c] = k % 5, k % 4
                a.bmode[r, c] = rng.integers(0, 10, (4, 4))
                k += 1
                continue
            a.ref[r, c] = rng.integers(1, 4)
            mv = rng.integers(-64, 65, (4, 4, 2))
            if rng.random() < 1 / 3:
                a.ymode[r, c], a.splitmv_pid[r, c] = T.SPLITMV, 3
                a.bmode[r, c] = T.NEW4X4
            else:
                a.ymode[r, c] = rng.integers(T.NEARESTMV, T.SPLITMV)
                mv[:] = mv[0, 0]
            a.sub_mv[r, c] = mv
            for ur in range(2):
                for uc in range(2):
                    a.uv_mv[r, c, ur, uc] = luma_to_chroma(*(
                        tuple(int(v) for v in mv[ur * 2 + i, uc * 2 + j])
                        for i in (0, 1) for j in (0, 1)))
    return refs, orig, a


def _words(a):
    return torch.from_numpy(rebase.mb_words(a.ref, a.ymode, a.uvmode,
                                            a.bmode, a.sub_mv, a.uv_mv))


@pytest.mark.parametrize("size,qi", [((80, 48), 4), ((176, 144), 40),
                                     ((176, 144), 127)],
                         ids=["80x48-qi4", "176x144-qi40", "176x144-qi127"])
def test_rebase_frame_plain_equals_jax_update_residues(size, qi):
    """The residue kernel's plain version of a whole frame against the JAX
    package's host update_residues (inter macroblocks through
    _apply_inter_mb, intra ones through _apply_intra_mb in raster order):
    every macroblock's coefficients, nonzero and Y2 flags, and the three
    reconstruction planes, equal."""
    width, height = size
    refs, orig, a = _frame_inputs(width, height, qi + width)
    intra = a.ref == T.CURRENT_FRAME
    inter = ~intra
    assert set(a.ymode[intra]) == {T.DC_PRED, T.V_PRED, T.H_PRED,
                                   T.TM_PRED, T.B_PRED}
    assert set(a.uvmode[intra]) == {T.DC_PRED, T.V_PRED, T.H_PRED,
                                    T.TM_PRED}
    assert (a.ymode[inter] == T.SPLITMV).any() \
        and (a.ymode[inter] != T.SPLITMV).any()

    jenc = JEncoder(width, height, device_encode=False)
    jenc.references = JReferences(*(JRaster(width, height, *(
        refs[p][k] for p in range(3))) for k in range(3)))
    _, want, _, wrec = JRB.update_residues(
        jenc, tuple(orig), JInterFrameHeader(), a,
        JQuantIndices(y_ac_qi=qi), False)

    q = QuantIndices(y_ac_qi=qi).quantizer()
    recon = [torch.zeros(o.shape, dtype=torch.uint8) for o in orig]
    out = rebase.rebase_frame_plain(
        [torch.from_numpy(o) for o in orig],
        {p: tuple(torch.from_numpy(refs[k])) for k, p in enumerate("yuv")},
        _words(a), [int(q[k]) for k in QUANT_KEYS], recon)
    co, nz, y2 = rebase.split_out(out.numpy())
    np.testing.assert_array_equal(co, want.coeffs)
    np.testing.assert_array_equal(nz, want.has_nonzero)
    np.testing.assert_array_equal(y2, want.y2_coded)
    for got, w in zip(recon, (wrec.y, wrec.u, wrec.v)):
        np.testing.assert_array_equal(got.numpy(), w)
    assert nz[intra].any() and nz[inter].any()
    assert not y2[intra & (a.ymode == T.B_PRED)].any()


def test_inter_residues_wrapper_takes_plain_only_on_cpu(monkeypatch):
    """The residue wrapper (rebase_frame) runs the plain version for CPU
    tensors, without counting a launch, and the kernel is never built on
    a CPU host; the checks it makes before a launch raise on what the
    kernel does not take."""
    refs, orig, a = _frame_inputs(80, 48, 5)
    q = QuantIndices(y_ac_qi=40).quantizer()
    quant = [int(q[k]) for k in QUANT_KEYS]
    t = torch.from_numpy
    args = dict(orig=[t(o) for o in orig],
                refs={p: tuple(t(refs[k])) for k, p in enumerate("yuv")},
                words=_words(a), quant=quant,
                recon=[torch.zeros(o.shape, dtype=torch.uint8)
                       for o in orig])
    calls = []
    plain = rebase_cuda.rebase_frame_plain
    monkeypatch.setattr(rebase_cuda, "rebase_frame_plain",
                        lambda *x: calls.append(1) or plain(*x))
    monkeypatch.setattr(rebase_cuda, "_entry", lambda: pytest.fail(
        "the kernel was reached for CPU tensors"))
    before = (rebase_cuda.launches, rebase_cuda.kernel_launches)
    out = rebase_cuda.rebase_frame(**args)
    assert calls == [1] and out.shape == (3, 5, rebase.OUT_WORDS)
    assert (rebase_cuda.launches, rebase_cuda.kernel_launches) == before

    cpu = torch.device("cpu")
    slots, got_q = rebase_cuda.check_args(dev=cpu, **args)
    assert len(slots) == 9 and got_q == quant

    def rejects(exc, **change):
        with pytest.raises(exc):
            rebase_cuda.check_args(dev=cpu, **dict(args, **change))
    rejects(TypeError, words=args["words"].to(torch.int64))
    rejects(ValueError, words=args["words"][:, :, :16])
    rejects(ValueError, refs=dict(args["refs"], u=args["refs"]["u"][:2]))
    rejects(ValueError, refs=dict(args["refs"], y=(args["recon"][0],) * 3))
    rejects(ValueError, quant=quant[:5] + [3])
    odd = torch.zeros(orig[1].size + 1, dtype=torch.uint8)[1:]
    rejects(ValueError, orig=args["orig"][:1] + [odd.view(orig[1].shape)]
            + args["orig"][2:])


# ---------------------------------------------------- (b) reencode itself

W, H = 80, 48


@functools.lru_cache(maxsize=None)
def _rebase_inputs(interior_key_frame):
    """The clip, chunk 0's exit state (two frames at qi 44, the JAX host
    encoder) and an independently encoded prediction chunk of frames 2-5,
    as tests/test_rebase_device.py sets them up; frame 4 is a scene cut
    (intra macroblocks in frame 5, B_PRED and whole-mode).  With
    ``interior_key_frame`` the prediction encodes frame 4 as a key frame."""
    clip = gen_clip(W, H, 6, seed=41)
    clip[4] = gen_clip(W, H, 6, seed=141)[4]
    enc0 = JEncoder(W, H, device_encode=False)
    for f in clip[:2]:
        enc0.encode_with_quantizer(f, 44)
    state = jserdes.save_decoder(enc0.state, enc0.references)
    encp = JEncoder(W, H, device_encode=False)
    pred = [encp.encode_with_quantizer(
        f, 44, key_frame=k == 0 or (interior_key_frame and k == 2))
        for k, f in enumerate(clip[2:])]
    return clip, state, pred


def _to_splitmv(arrays, r, c):
    """Make inter macroblock (r, c) a SPLITMV one (16 partitions, NEW4X4
    each) whose last vector, which later macroblocks' census reads, stays
    what it was; the other vectors move by seeded even steps (vectors are
    coded in units of 2)."""
    rng = np.random.default_rng(r * 7 + c)
    step = 2 * rng.integers(-12, 13, (4, 4, 2))
    step[3, 3] = 0
    arrays.sub_mv[r, c] = arrays.sub_mv[r, c, 3, 3].astype(int) + step
    arrays.ymode[r, c] = T.SPLITMV
    arrays.splitmv_pid[r, c] = 3
    arrays.bmode[r, c] = T.NEW4X4
    for ur in range(2):
        for uc in range(2):
            arrays.uv_mv[r, c, ur, uc] = luma_to_chroma(*(
                tuple(int(v) for v in arrays.sub_mv[r, c, ur * 2 + a,
                                                    uc * 2 + b])
                for a in (0, 1) for b in (0, 1)))


def _with_splitmv(pred):
    """One inter macroblock of each interframe made SPLITMV (the encoders
    never choose it; prediction streams from elsewhere may hold it)."""
    for kf, _, arrays in pred:
        if not kf:
            rows, cols = np.nonzero(arrays.ref != T.CURRENT_FRAME)
            _to_splitmv(arrays, int(rows[len(rows) // 2]),
                        int(cols[len(rows) // 2]))
    return pred


def _jax_prediction(payloads):
    state = JDecoderState.initial(W, H)
    out = []
    for p in payloads:
        chunk = JUncompressedChunk(p, W, H)
        header, arrays, _ = JFrameParser(state).parse(chunk)
        out.append((chunk.key_frame, header, arrays))
    return _with_splitmv(out)


@pytest.mark.parametrize("case", ["kf_weight_0.5", "kf_weight_1.0",
                                  "extra_frame_chunk", "interior_key_frame"])
def test_reencode_byte_identical_to_jax(case, tmp_path):
    """The port's reencode against the JAX host reencode: every frame's
    bytes and the minihash after the chunk; the residue update meets
    B_PRED and whole-mode intra macroblocks and a SPLITMV macroblock, and
    the port's Decoder re-decodes the rebased frames from the entry state
    to the encoder's minihash."""
    interior = case == "interior_key_frame"
    extra = case == "extra_frame_chunk"
    weight = 1.0 if case == "kf_weight_1.0" else 0.5
    clip, state, payloads = _rebase_inputs(interior)

    jenc = JEncoder(W, H, device_encode=False)
    jenc.state, jenc.references = jserdes.load_decoder(state)
    with JIVFWriter(tmp_path / "jax.ivf", "VP80", W, H) as writer:
        JRB.reencode(jenc, clip[2:], _jax_prediction(payloads), weight,
                     extra, writer)

    pred = _with_splitmv(RB.parse_prediction(payloads,
                                             Decoder(W, H, device="cpu")))
    assert [kf for kf, _, _ in pred] == [True, False, interior, False]
    # the intra macroblocks the residue update meets: their modes
    modes = [int(m) for kf, _, a in pred[1:] if not kf
             for m in a.ymode[a.ref == T.CURRENT_FRAME]]
    enc = Encoder(W, H, device="cpu")
    enc.state, enc.references = serdes.load_decoder(state, device="cpu")
    with IVFWriter(tmp_path / "port.ivf", "VP80", W, H) as writer:
        RB.reencode(enc, clip[2:], pred, weight, extra, writer)
    got = list(IVFReader(str(tmp_path / "port.ivf")))
    want = list(IVFReader(str(tmp_path / "jax.ivf")))
    assert len(got) == len(want) == 4 - extra
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, "rebased frame %d differs" % i
    assert enc.minihash() == jenc.minihash()
    assert T.B_PRED in modes and set(modes) - {T.B_PRED}
    assert any((a.ymode == T.SPLITMV).any() for kf, _, a in pred if not kf)

    dec_state, dec_refs = serdes.load_decoder(state, device="cpu")
    dec = Decoder(W, H, state=dec_state, references=dec_refs, device="cpu")
    for p in got:
        dec.decode_frame(p)
    assert dec.minihash() == enc.minihash()


# ------------------------------------------------ (c) the cluster encode

def test_parallel_encode_matches_jax(tmp_path):
    """parallel_encode(device="cpu") against the JAX package's at 64x48
    (8 frames, chunks of 3): one worker in this process, then three
    worker processes; the streams are byte for byte the same."""
    w, h = 64, 48
    clip = gen_clip(w, h, 8, seed=29)
    with JIVFWriter(tmp_path / "jax.ivf", "VP80", w, h, 1, 1, 0) as writer:
        jparallel_encode(clip, w, h, writer, y_ac_qi=48, chunk_frames=3,
                         workers=1)
    want = (tmp_path / "jax.ivf").read_bytes()
    for workers in (1, 3):
        out = tmp_path / ("port%d.ivf" % workers)
        with IVFWriter(out, "VP80", w, h, 1, 1, 0) as writer:
            stats = parallel_encode(clip, w, h, writer, y_ac_qi=48,
                                    chunk_frames=3, workers=workers,
                                    device="cpu")
        assert [s["rebased"] for s in stats] == [False, True, True]
        assert out.read_bytes() == want, "%d workers" % workers


# ----------------------------------------------------------- (d) the CLI

@pytest.mark.parametrize("command", ["enc_r", "enc_parallel"])
def test_xc_rebase_commands_match_jax(command, tmp_path):
    """``xc enc -r`` (after ``xc enc -O`` writes chunk 0's state, with -O
    on the rebase too) and ``xc enc-parallel`` through the port's main()
    on the CPU against the JAX CLI: IVFs and state files byte for byte."""
    w, h = 64, 48
    clip = gen_clip(w, h, 6, seed=43)
    sides = (("jax", jxc.main, []), ("port", xc.main, ["--device", "cpu"]))
    if command == "enc_parallel":
        y4m = tmp_path / "in.y4m"
        write_y4m(str(y4m), clip, w, h)
        for name, main, extra in sides:
            main(["enc-parallel", str(y4m), "-y", "48", "-c", "3", "-j", "1",
                  "-o", str(tmp_path / (name + ".ivf"))] + extra)
        outs = [".ivf"]
    else:
        c0, c1 = tmp_path / "c0.y4m", tmp_path / "c1.y4m"
        write_y4m(str(c0), clip[:3], w, h)
        write_y4m(str(c1), clip[3:], w, h)
        for name, main, extra in sides:
            t = lambda s: str(tmp_path / (name + s))
            main(["enc", str(c0), "-y", "44", "-o", t("0.ivf"),
                  "-O", t("0.state")] + extra)
            main(["enc", str(c1), "-y", "44", "-o", t("p.ivf")] + extra)
            main(["enc", str(c1), "-r", "-I", t("0.state"), "-p", t("p.ivf"),
                  "-w", "0.5", "-o", t(".ivf"), "-O", t(".state")] + extra)
        outs = ["0.ivf", "0.state", "p.ivf", ".ivf", ".state"]
    for s in outs:
        assert (tmp_path / ("port" + s)).read_bytes() == \
            (tmp_path / ("jax" + s)).read_bytes(), s
    assert len(IVFReader(str(tmp_path / "port.ivf"))) == \
        (6 if command == "enc_parallel" else 3)


# ---------------------------------------------------------------- (f) slow

@pytest.mark.slow
def test_chip_smoke_rebase_digests_from_jax(tmp_path):
    """chip_smoke.REBASE_SHA1 and CLUSTER_SHA1, recomputed with the JAX
    package: its FilePlayer decodes frames 0-5 of the 720p fixture, its
    host encoder encodes chunk 0 (frames 0-2) and the prediction chunk
    (frames 3-5) at qi 48, its host reencode rebases the prediction
    against chunk 0's state at key-frame weight 0.5 (and the minihash after
    each frame), and its parallel_encode (one worker, chunks of 3) encodes
    frames 0-5, which its FilePlayer decodes (the minihash after each
    frame).  A few minutes of CPU."""
    from alfalfa_tpu.decoder.decoder import FilePlayer as JFilePlayer
    from alfalfa_tpu.util.ivf import IVFReader as JIVFReader
    frames = []
    for raster in JFilePlayer(str(FIXTURES / "inter_1280x720_q48.ivf")):
        frames.append(tuple(np.array(p) for p in raster.display()))
        if len(frames) == chip_smoke.REBASE_FRAMES:
            break
    w, h, qi = 1280, 720, chip_smoke.REBASE_QI
    sha = lambda p: hashlib.sha1(p).hexdigest()
    n0 = chip_smoke.REBASE_CHUNK
    enc0 = JEncoder(w, h, device_encode=False)
    for f in frames[:n0]:
        enc0.encode_with_quantizer(f, qi)
    encp = JEncoder(w, h, device_encode=False)
    payloads = [encp.encode_with_quantizer(f, qi) for f in frames[n0:]]
    pstate = JDecoderState.initial(w, h)
    pred = []
    for p in payloads:
        chunk = JUncompressedChunk(p, w, h)
        header, arrays, _ = JFrameParser(pstate).parse(chunk)
        pred.append((chunk.key_frame, header, arrays))
    reb = JEncoder(w, h, device_encode=False)
    reb.state, reb.references = enc0.state, enc0.references
    got, minihashes = [], []

    class Sink:
        def append_frame(self, payload):
            got.append(sha(payload))
            minihashes.append(reb.minihash())

    JRB.reencode(reb, frames[n0:], pred, chip_smoke.REBASE_KF_WEIGHT,
                 False, Sink())
    assert got == chip_smoke.REBASE_SHA1
    assert minihashes == chip_smoke.REBASE_MINIHASH
    with JIVFWriter(tmp_path / "c.ivf", "VP80", w, h, 1, 1, 0) as writer:
        jparallel_encode(frames, w, h, writer, y_ac_qi=qi, chunk_frames=n0,
                         workers=1, kf_q_weight=chip_smoke.REBASE_KF_WEIGHT)
    got = [sha(p) for p in JIVFReader(str(tmp_path / "c.ivf"))]
    assert got == chip_smoke.CLUSTER_SHA1
    player = JFilePlayer(str(tmp_path / "c.ivf"))
    assert [player.decoder.minihash() for _ in player] == \
        chip_smoke.CLUSTER_MINIHASH
