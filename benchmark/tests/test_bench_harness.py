"""The harness on the CPU: cells, configurations and metrics found by name,
both drivers end to end through the port's plain path at a tiny size, the
faults each cell can have caught, the controls failing, the arithmetic
of the end-to-end metrics, and the frozen counts never above what a call
moves."""
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.bounds import kernels as bounds

BENCH = harness.BENCH
KINDS = ("drivers", "metrics", "configs", "workloads")
DECODE, ENCODE = "excamera-4k.decode-g16", "excamera-4k.chunk-encode"
# the real cells at a size the CPU decodes in seconds
TINY = {
    DECODE: (dict(width=64, height=48, chunks_per_string=4, chunk_frames=3,
                  quality="rt"), {}),
    ENCODE: (dict(width=64, height=48, chunks_per_string=4, chunk_frames=3), {}),
}
# limits that hold only at the cell's own size: the bytes ratio's is set at
# 4K, where a frame's headers weigh nothing; at 64x48 they do
AT_SIZE = ("inter_over_key_bytes",)


def tiny_bench(root):
    """A copy of the benchmark's data and modules under ``root`` with a
    ``tiny.<cell>`` cell beside each real one."""
    for kind in KINDS:
        shutil.copytree(os.path.join(BENCH, kind), os.path.join(root, kind))
    for name, (cfg_over, traffic_over) in TINY.items():
        wl, cfg = harness.cell(name)
        cfg = dict(cfg, **cfg_over)
        wl = json.loads(json.dumps(wl))
        wl["config"] = "tiny." + wl["config"]
        wl["traffic"].update(traffic_over)
        limits = wl["traffic"].get("check_limits")
        if limits:
            wl["traffic"]["check_limits"] = {k: v for k, v in limits.items()
                                             if k not in AT_SIZE}
        with open(os.path.join(root, "configs", wl["config"] + ".json"), "w") as f:
            json.dump(cfg, f)
        with open(os.path.join(root, "workloads", "tiny." + name + ".json"), "w") as f:
            json.dump(wl, f)
    return root


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_bench(str(tmp_path_factory.mktemp("bench")))


def run(bench, cell, seed=2 ** 33 + 5, seconds=1.5, trace=False):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run_cell(cell, seed, seconds, trace, device="cpu",
                          bench=str(bench), out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


def test_every_cell_names_files_that_exist():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    e2e = {m["name"] for m in spec["end_to_end"]}
    cells = {w["name"]: w for w in spec["workloads"]}
    assert {c["name"] for c in spec["configs"]} == {w["config"] for w in spec["workloads"]}
    for c in spec["configs"]:
        assert c["file"] == "benchmark/configs/%s.json" % c["name"]
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
    for name, w in cells.items():
        wl, cfg = harness.cell(name)
        assert wl["config"] == w["config"] == cfg["name"]
        assert os.path.exists(os.path.join(BENCH, "drivers", wl["driver"] + ".py"))
        assert "setup_s" in wl["end_to_end"] and len(wl["end_to_end"]) >= 2
        assert wl["per_layer"]
        for m in wl["end_to_end"] + wl["per_layer"]:
            if m != "setup_s":
                mod = harness.load_module("metrics", m)
                assert callable(mod.read) and mod.UNIT
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            wl, _ = harness.cell(w)
            assert m["name"] in wl["per_layer"] and m["moves"] in wl["end_to_end"]
    for m in spec["end_to_end"]:
        listed = m.get("workloads", cells)
        for w in listed:
            assert m["name"] in harness.cell(w)[0]["end_to_end"]


def _digest(root):
    h = {}
    for kind in KINDS:
        for name in sorted(os.listdir(os.path.join(root, kind))):
            with open(os.path.join(root, kind, name), "rb") as f:
                h[(kind, name)] = hashlib.sha1(f.read()).hexdigest()
    return h


def test_a_new_cell_and_metric_are_found_by_name(tmp_path):
    root = tiny_bench(str(tmp_path))
    before = _digest(root)
    with open(os.path.join(root, "metrics", "positions.decode.py"), "w") as f:
        f.write('UNIT = "positions"\n\n\ndef read(run):\n'
                '    return run.records["frames"] / run.records["geometry"]["G"]\n')
    wl, _ = harness.cell("tiny." + DECODE, root)
    wl["per_layer"] = wl["per_layer"] + ["positions.decode"]
    wl["traffic"]["check_frames"] = [1, 1]
    with open(os.path.join(root, "workloads", "tiny.added.json"), "w") as f:
        json.dump(wl, f)
    rc, res, err = run(root, "tiny.added", trace=True)
    assert rc == 0, err
    assert res["correct"] and res["metrics"]["positions.decode"]["value"] > 0
    after = _digest(root)
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize("cell", [DECODE, ENCODE])
def test_cell_runs_and_is_correct_on_the_plain_path(tiny, cell):
    rc, res, err = run(tiny, "tiny." + cell, seconds=3.0)
    assert rc == 0, err
    assert res["correct"], res["checks"]
    limits = wl_limits(cell)
    assert all(v["value"] == 0 for k, v in res["checks"].items() if limits.get(k, 0) == 0)
    assert list(res)[-1] == "checks"
    names = harness.cell(cell)[0]["end_to_end"]
    assert set(res["metrics"]) == set(names)
    assert all(m["value"] > 0 for m in res["metrics"].values())


def _decode_fault(kind):
    """decode_stream broken underneath: a step that returns its state
    unchanged (frame 1 repeats frame 0), half the batch left out, a
    decoded pixel altered where it is produced."""
    from alfalfa_tpu_torch.parallel import gop
    orig = gop.BatchedGopDecoder.decode_stream

    def broken(self, batches):
        prev = None
        for n, ((y, u, v), show) in enumerate(orig(self, batches)):
            if kind == "state_unchanged" and n % 3 == 1:
                y, u, v = prev
            elif kind == "half_batch":
                y, u, v = (p.clone() for p in (y, u, v))
                for p in (y, u, v):
                    p[self.G // 2:] = 0
            elif kind == "answer_altered":
                y = y.clone()
                y[:, 5, 7] ^= 1
            prev = (y, u, v)
            yield (y, u, v), show
    return gop.BatchedGopDecoder, "decode_stream", broken


def _encode_fault(kind):
    """The chunk encode broken underneath: an encode step that leaves the
    encoder's state unchanged, the second half of a chunk's frames left
    out (the encoder hands back its last payload again), a payload byte
    altered where it is produced, every frame one quantizer step coarser."""
    from alfalfa_tpu_torch.encoder.encoder import Encoder
    orig = Encoder.encode_with_quantizer
    last = {}

    def broken(self, yuv, qi, key_frame=None):
        if kind == "quantizer_off":
            return orig(self, yuv, qi + 1, key_frame)
        if kind == "half_batch" and self.frame_no >= 2:
            self.frame_no += 1
            return last[id(self)]
        before = (self.state.copy(), self.references.copy())
        payload = orig(self, yuv, qi, key_frame)
        if kind == "state_unchanged" and self.frame_no == 2:
            self.state, self.references = before
        if kind == "answer_altered" and self.frame_no == 2:
            k = len(payload) // 2
            payload = payload[:k] + bytes([payload[k] ^ 0x55]) + payload[k + 1:]
        last[id(self)] = payload
        return payload
    return Encoder, "encode_with_quantizer", broken


@pytest.mark.parametrize("cell,fault", [
    (DECODE, "state_unchanged"), (DECODE, "half_batch"), (DECODE, "answer_altered"),
    (ENCODE, "state_unchanged"), (ENCODE, "half_batch"), (ENCODE, "answer_altered"),
    (ENCODE, "quantizer_off")])
def test_a_fault_underneath_makes_the_run_not_correct(tiny, monkeypatch, cell, fault):
    target, attr, broken = {DECODE: _decode_fault, ENCODE: _encode_fault}[cell](fault)
    monkeypatch.setattr(target, attr, broken)
    rc, res, err = run(tiny, "tiny." + cell, seconds=3.0)
    assert rc == 0, err
    assert res["correct"] is False, res["checks"]


def test_the_decode_control_is_not_correct(tiny):
    from benchmark import control
    (res,) = control.control("tiny." + DECODE, 7, device="cpu", bench=str(tiny))
    assert res["correct"] is False, res


@pytest.fixture(scope="module")
def encode_controls(tmp_path_factory):
    """The chunk-encode cell's sound readings and controls at 176x144, four
    frames a chunk, on two seeds: {(seed, control): result}."""
    from benchmark import control
    root = str(tmp_path_factory.mktemp("controls"))
    for kind in KINDS:
        shutil.copytree(os.path.join(BENCH, kind), os.path.join(root, kind))
    wl, cfg = harness.cell(ENCODE)
    cfg = dict(cfg, width=176, height=144, chunks_per_string=4, chunk_frames=4)
    wl["config"] = "small." + wl["config"]
    wl["traffic"]["check_among_first"] = 1
    wl["traffic"]["check_limits"] = {k: v for k, v in wl["traffic"]["check_limits"].items()
                                     if k not in AT_SIZE}
    with open(os.path.join(root, "configs", wl["config"] + ".json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "workloads", "small.json"), "w") as f:
        json.dump(wl, f)
    names = ("none",) + tuple(harness.load_module("drivers", "chunk_encode").CONTROLS)
    return {(seed, r["control"]): r for seed in (7, 8)
            for r in control.control("small", seed, device="cpu", bench=root, names=names)}


@pytest.mark.parametrize("name", ["precision", "input_ignored"])
def test_an_encode_control_is_not_correct_on_every_seed(encode_controls, name):
    for seed in (7, 8):
        assert encode_controls[(seed, "none")]["correct"], encode_controls[(seed, "none")]
        assert encode_controls[(seed, name)]["correct"] is False


def test_the_loop_filter_climb_catches_a_search_left_out(encode_controls):
    """Level 0 everywhere fails the climb on a seed whose search picks a
    level above 0 on some frame (at this size seed 8 does, seed 7 not);
    the sound runs read no gap at all."""
    for seed in (7, 8):
        assert encode_controls[(seed, "none")]["numbers"]["lf_climb_gap"] == 0.0
    assert any(encode_controls[(seed, "lf_search_left_out")]["correct"] is False
               for seed in (7, 8))


def wl_limits(cell):
    return harness.cell(cell)[0]["traffic"].get("check_limits", {})


def test_rates_see_a_planted_stall():
    """A rate over all of the window's time: a stall in the window lowers
    it by the share of the time it takes."""
    for name in ("decode_fps", "encode_fps"):
        rate = harness.load_module("metrics", name)
        run = harness.Run({}, {})
        run.records = {"frames": 600, "window_s": 10.0}
        base = rate.read(run)
        run.records = {"frames": 600, "window_s": 12.5}
        assert base == pytest.approx(60.0)
        assert rate.read(run) == pytest.approx(48.0)


def _tensor_bytes(*objs):
    import torch
    n = 0
    for o in objs:
        if isinstance(o, (tuple, list)):
            n += _tensor_bytes(*o)
        elif isinstance(o, dict):
            n += _tensor_bytes(*o.values())
        elif isinstance(o, torch.Tensor):
            n += o.numel() * o.element_size()
    return n


def test_the_frozen_counts_never_exceed_what_a_call_moves(tiny, monkeypatch):
    """Each count is at most the bytes of the tensors the port's call
    takes and gives at a small size, so a share cannot pass 100 %."""
    from alfalfa_tpu_torch.decoder import reconstruct_torch as rt
    from alfalfa_tpu_torch.encoder import encode_intra
    seen = {}

    def spy(name, fn):
        def call(*a, **k):
            out = fn(*a, **k)
            seen.setdefault(name, []).append((a, k, out))
            return out
        return call
    monkeypatch.setattr(rt, "wavefront_decode", spy("k1", rt.wavefront_decode))
    d = list(rt._stage_ab.__defaults__)
    d[-1] = spy("k2", d[-1])
    monkeypatch.setattr(rt._stage_ab, "__defaults__", tuple(d))
    monkeypatch.setattr(encode_intra, "encode_kf_frame",
                        spy("k7", encode_intra.encode_kf_frame))
    assert run(tiny, "tiny." + DECODE)[0] == 0
    assert run(tiny, "tiny." + ENCODE)[0] == 0
    counts = {"k1": bounds.k1_bytes, "k2": bounds.k2_bytes, "k7": bounds.k7_bytes}
    for name in counts:
        assert seen.get(name), name
        for a, k, out in seen[name]:
            if name == "k1":
                n_mb = a[10].numel()                 # the intra flags, (G, R, C)
            elif name == "k2":
                n_mb = a[2][..., 0, 0, 0].numel()    # sub_mv (G, R, C, 4, 4, 2)
            else:                                    # oy (16R, 16C)
                n_mb = (a[0].shape[-2] // 16) * (a[0].shape[-1] // 16)
            assert counts[name](n_mb) <= _tensor_bytes(a, k, out), name


def test_a_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                        DECODE, "--seed", str(2 ** 40), "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, env=env, cwd=harness.ROOT)
    assert p.returncode != 0 and p.stdout == ""


def test_reduce_trace_busy_idle_and_gaps():
    dev = [(100, 200, "a"), (150, 300, "b"), (500, 600, "a")]
    ann = [(0, 1000, "outer"), (300, 500, "inner")]
    busy, kernels, bd = harness.reduce_trace(dev, ann, 0, 1000)
    assert busy == pytest.approx(300e-9)
    assert kernels["a"] == [2, pytest.approx(200e-9)]
    assert dict(bd["idle_gaps"]) == pytest.approx(
        {"outer": 500e-9, "inner": 200e-9})


@pytest.mark.card
def test_tiny_cells_on_the_card(tiny, card):
    for cell in TINY:
        out, err = io.StringIO(), io.StringIO()
        rc = harness.run_cell("tiny." + cell, 11, 3.0, False, device=card,
                              bench=str(tiny), out=out, err=err)
        assert rc == 0, err.getvalue()
        assert json.loads(out.getvalue().splitlines()[-1])["correct"]


def test_kernel_names_match_whole_symbols():
    r = harness.Run({}, {})
    r.kernels = {"void enc_kf_row_kernel<false>(EncArgs)": [3, 1.0],
                 "wave_row_kernel(WaveRowArgs)": [2, 0.5],
                 "intra_wave_row_kernel(A)": [1, 9.0]}
    assert r.kernel_seconds(("enc_kf_row_kernel",)) == (3, 1.0)
    assert r.kernel_seconds(("wave_row_kernel",)) == (2, 0.5)
