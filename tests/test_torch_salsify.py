"""The Salsify slice of the port on the CPU, against the JAX package in the
same process: the port's net/ layer (packets, ACKs, fragments, the pacer)
byte for byte; the sender's control functions on the same seeded
sequences; the receiver on the same scripted datagrams (lossless, a dropped
tail fragment, a source-state switch), rasters, states and ACK bytes equal;
the loopback cases of tests/test_salsify.py through the port
(``device="cpu"``: the kernel wrappers take their plain versions); the
payloads of a port loopback replayed through the JAX package's fast path;
and ``xc run-contest``.

Every socket binds port 0 and reads its port back: the JAX package's
tests bind fixed ports and run beside these under xdist.
"""
import random
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)    # many tiny ops: threads only add contention

from alfalfa_tpu import net as jnet  # noqa: E402
from alfalfa_tpu.net import socket as jsocket  # noqa: E402
from alfalfa_tpu.salsify import receiver as jreceiver  # noqa: E402
from alfalfa_tpu.salsify import sender as jsender  # noqa: E402

from alfalfa_tpu_torch import net  # noqa: E402
from alfalfa_tpu_torch.cli import xc  # noqa: E402
from alfalfa_tpu_torch.encoder import Encoder  # noqa: E402
from alfalfa_tpu_torch.input.frame_input import FrameInput  # noqa: E402
from alfalfa_tpu_torch.net import socket as psocket  # noqa: E402
from alfalfa_tpu_torch.salsify import receiver as preceiver  # noqa: E402
from alfalfa_tpu_torch.salsify import sender as psender  # noqa: E402
from alfalfa_tpu_torch.util.y4m import Y4MWriter  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent / "fixtures"))
from gen_inputs import gen_clip  # noqa: E402

W, H, N_FRAMES = 64, 48, 6


# ------------------------------------------------------- (a) wire format

def _random_packet(rng, mod):
    n = rng.randrange(1, 9)
    return mod.Packet(connection_id=rng.randrange(1 << 16),
                      source_state=rng.randrange(1 << 32),
                      target_state=rng.randrange(1 << 32),
                      frame_no=rng.randrange(1 << 32),
                      fragment_no=rng.randrange(n),
                      fragments_in_this_frame=n,
                      time_since_last=rng.randrange(1 << 32),
                      payload=bytes(rng.randrange(256) for _ in
                                    range(rng.randrange(1, 1401))))


def _wire_packet():
    for seed in range(40):
        mine, theirs = (_random_packet(random.Random(seed), m)
                        for m in (net, jnet))
        raw = mine.to_bytes()
        assert raw == theirs.to_bytes()
        for a, b in ((net.Packet.parse(theirs.to_bytes()), theirs),
                     (jnet.Packet.parse(raw), mine)):
            for f in net.Packet.__slots__:
                assert getattr(a, f) == getattr(b, f)
    for bad in (dict(fragment_no=5, fragments_in_this_frame=5, payload=b"x"),
                dict(fragment_no=0, fragments_in_this_frame=1, payload=b"")):
        with pytest.raises(ValueError):
            net.Packet.parse(jnet.Packet(**bad).to_bytes())


def _wire_ack():
    rng = random.Random(3)
    for n in (0, 1, 2, 17):
        fields = (rng.randrange(1 << 16), rng.randrange(1 << 32),
                  rng.randrange(1 << 16), rng.randrange(1 << 32),
                  rng.randrange(1 << 32),
                  [rng.randrange(1 << 32) for _ in range(n)])
        raw = net.AckPacket(*fields).to_bytes()
        assert raw == jnet.AckPacket(*fields).to_bytes()
        assert len(raw) == 16 + 4 + 4 * n
        for a in (net.AckPacket.parse(raw), jnet.AckPacket.parse(raw)):
            assert (a.connection_id, a.frame_no, a.fragment_no, a.avg_delay,
                    a.current_state, a.complete_states) == fields


def _wire_fragments():
    rng = random.Random(4)
    for size in (1, 1400, 1401, 5000):
        frame = bytes(rng.randrange(256) for _ in range(size))
        args = (7, rng.randrange(1 << 32), rng.randrange(1 << 32), 9, 12345)
        mine = net.FragmentedFrame(*args, whole_frame=frame)
        theirs = jnet.FragmentedFrame(*args, whole_frame=frame)
        wire = [p.to_bytes() for p in mine.packets()]
        assert wire == [p.to_bytes() for p in theirs.packets()]
        assert mine.fragments_in_this_frame == -(-size // 1400)
        # each side reassembles the other's datagrams, shuffled
        for mod, other in ((net, jnet), (jnet, net)):
            pkts = [other.Packet.parse(b) for b in wire]
            rng.shuffle(pkts)
            inc = mod.FragmentedFrame(7, packet=mod.Packet.parse(
                pkts[0].to_bytes()))
            for p in pkts[1:]:
                inc.add_packet(mod.Packet.parse(p.to_bytes()))
            assert inc.complete() and inc.frame() == frame
            assert (inc.source_state, inc.target_state, inc.frame_no) == \
                args[1:4]


def _wire_partial():
    frame = bytes(range(256)) * 20      # 5120 bytes -> 4 fragments
    wire = [p.to_bytes() for p in
            net.FragmentedFrame(1, 0, 0, 0, 0, whole_frame=frame).packets()]
    for order in ((0, 2), (0, 2, 1), (1, 3), (3, 0, 1)):
        got = []
        for mod in (net, jnet):
            inc = mod.FragmentedFrame(1, packet=mod.Packet.parse(
                wire[order[0]]))
            for k in order[1:]:
                inc.add_packet(mod.Packet.parse(wire[k]))
            assert not inc.complete()
            got.append(inc.partial_frame())
        assert got[0] == got[1]
        n = 0
        while n in order:
            n += 1
        assert got[0] == frame[:1400 * n]


def _wire_pacer():
    pacer = net.Pacer()
    assert pacer.ms_until_due() == 1000
    pacer.push(b"a", 0)
    assert pacer.ms_until_due() == 0
    pacer.push(b"b", 50_000)  # 50 ms after "a"
    assert pacer.front() == b"a"
    pacer.pop()
    assert 0 < pacer.ms_until_due() <= 50
    pacer.pop()
    assert pacer.empty()
    # the same pushes leave the same gaps between due times as the JAX pacer
    gaps = []
    for mod in (net, jnet):
        p = mod.Pacer()
        for k, d in enumerate((0, 500, 2000, 1999, 7)):
            p.push(b"%d" % k, d)
        q = [t for t, _ in p._queue]
        gaps.append([round((b - a) * 1e6) for a, b in zip(q, q[1:])])
    assert gaps[0] == gaps[1] == [500, 2000, 1999, 7]


WIRE = {"packet": _wire_packet, "ack": _wire_ack,
        "fragments": _wire_fragments, "partial_frame": _wire_partial,
        "pacer": _wire_pacer}


@pytest.mark.parametrize("case", list(WIRE))
def test_wire_format_matches_jax(case):
    """Packets, ACKs, fragmentation and reassembly byte-equal to the JAX
    package's (22-byte little-endian header, packet.cc:90-109), each side
    parsing the other's bytes; the pacer's spacing."""
    WIRE[case]()


# -------------------------------------------------- (b) sender control

def _control_quantizer_and_target():
    for q in range(-10, 140):
        for inc in (-17, 0, 23):
            assert psender.clamp_quantizer(q, inc) == \
                jsender.clamp_quantizer(q, inc)
    rng = np.random.default_rng(11)
    for _ in range(500):
        delay, acked = int(rng.integers(0, 200_000)), int(rng.integers(0, 90))
        sent = acked + int(rng.integers(0, 120))
        assert psender.target_size(delay, acked, sent) == \
            jsender.target_size(delay, acked, sent)


def _control_averages():
    rng = np.random.default_rng(12)
    ts = np.cumsum(rng.integers(0, 1_500_000, 300))
    mine, theirs = psender.AverageEncodingTime(), jsender.AverageEncodingTime()
    for t in ts.tolist():
        mine.add(t)
        theirs.add(t)
        assert (mine.value, mine.int_value()) == \
            (theirs.value, theirs.int_value())
    mine = preceiver.AverageInterPacketDelay()
    theirs = jreceiver.AverageInterPacketDelay()
    ts = np.cumsum(rng.integers(0, 40_000, 300))
    for t, grace in zip(ts.tolist(), rng.integers(0, 30_000, 300).tolist()):
        mine.add(t, grace)
        theirs.add(t, grace)
        assert (mine.value, mine.int_value()) == \
            (theirs.value, theirs.int_value())


def _cc_stub():
    return types.SimpleNamespace(cc_quantizer=32, cc_rate_ewma=0,
                                 avg_delay=None, next_cc_update=0.0,
                                 cc_update_interval=0.0)


def _control_update_cc():
    rng = np.random.default_rng(13)
    mine, theirs = _cc_stub(), _cc_stub()
    delays = [None] + rng.integers(1, 60_000, 200).tolist() + [10 ** 9, 1]
    seen = set()
    for d in delays:
        mine.avg_delay = theirs.avg_delay = d
        mine.next_cc_update = theirs.next_cc_update = 0.0
        psender.SalsifySender._update_cc(mine)
        jsender.SalsifySender._update_cc(theirs)
        assert (mine.cc_quantizer, mine.cc_rate_ewma) == \
            (theirs.cc_quantizer, theirs.cc_rate_ewma)
        seen.add(mine.cc_quantizer)
    assert 127 in seen and len(seen) > 10


def _state_stub(mod, sock_mod, acks):
    cls = mod.SalsifySender
    s = types.SimpleNamespace(
        initial_state=1, encoders={1: "e1"}, encoder_states=[],
        receiver_last_acked_state=None, receiver_assumed_state=None,
        receiver_complete_states=[], conservative_until=0.0,
        connection_id=1337, cumulative_fpf=[], last_acked=None,
        avg_delay=None, _log=lambda msg: None)
    s.socket = types.SimpleNamespace(recv=lambda: sock_mod.Datagram(
        acks.pop(0), ("127.0.0.1", 9), 0))
    for name in ("_ack_seq_no", "handle_ack", "prune_encoders",
                 "select_source_state"):
        setattr(s, name, types.MethodType(getattr(cls, name), s))
    return s


def _control_state_selection():
    """A scripted run of sends and ACKs (some stale, one of another
    connection, one naming a state the sender dropped): handle_ack,
    prune_encoders and select_source_state leave both senders alike."""
    rng = random.Random(14)
    script = []
    sent = [1]
    for step in range(60):
        if rng.random() < 0.5:
            script.append(("send", 100 + step, rng.randrange(1, 4)))
            sent.append(100 + step)
        else:
            frame = rng.randrange(0, max(1, len(sent)))
            held = sorted(rng.sample(sent, min(len(sent), rng.randrange(3))))
            state = rng.choice(sent) if rng.random() < 0.9 else 99999
            cid = 1337 if rng.random() < 0.95 else 7
            script.append(("ack", net.AckPacket(
                cid, frame, rng.randrange(3), rng.randrange(1, 50_000), state,
                held).to_bytes()))
    acks = [[e[1] for e in script if e[0] == "ack"] for _ in range(2)]
    stubs = [_state_stub(psender, psocket, acks[0]),
             _state_stub(jsender, jsocket, acks[1])]
    for event in script:
        picked = []
        for s in stubs:
            if event[0] == "send":
                _, target, fragments = event
                s.encoders[target] = "e%d" % target
                s.encoder_states.append(target)
                s.receiver_assumed_state = target
                prev = s.cumulative_fpf[-1] if s.cumulative_fpf else 0
                s.cumulative_fpf.append(prev + fragments)
            else:
                s.handle_ack()
            s.prune_encoders()
            picked.append((s.select_source_state(), sorted(s.encoders),
                           list(s.encoder_states), s.last_acked,
                           s.avg_delay, s.receiver_last_acked_state,
                           s.receiver_complete_states,
                           s.conservative_until > time.monotonic()))
        assert picked[0] == picked[1], event[0]
    assert any(s.conservative_until for s in stubs)


def _control_can_fuse():
    """The port's fuse test, on its encoders' attributes: the rt pair after
    frame 0 fuses; frame 0, two-pass, a single job and encoders on two
    devices do not (the JAX test reads device_encode, which the port's
    Encoder lacks).  The fused pair, on the fast path and (fast=False) on
    K8, gives each job the payload, frame count, quantizer and SSIM of a
    single encode."""
    clip = gen_clip(W, H, 2, seed=5)
    for fast in (True, False):
        key = Encoder(W, H, quality="rt", fast=fast, device="cpu")
        key.encode_with_quantizer(clip[0], 50)
        jobs = [("improve", clip[1], key.fork(), 33),
                ("fail-small", clip[1], key.fork(), 73)]
        assert psender.can_fuse_jobs(jobs)
        outs = psender.do_encode_jobs_fused(jobs)
        for out, (name, f, _, q) in zip(outs, jobs):
            single = key.fork()
            assert out.frame == single.encode_with_quantizer(f, q)
            assert (out.job_name, out.y_ac_qi, out.source_minihash) == \
                (name, q, key.minihash())
            for attr in ("frame_no", "last_y_ac_qi", "last_ssim"):
                assert getattr(out.encoder, attr) == getattr(single, attr)
            assert out.encoder.minihash() == single.minihash()
    base = Encoder(W, H, quality="rt", fast=True, device="cpu")
    raster = clip[0]

    def pair(enc):
        return [("improve", raster, enc.fork(), 30),
                ("fail-small", raster, enc.fork(), 70)]

    assert not psender.can_fuse_jobs(pair(base))            # frame 0
    base.frame_no = 1
    assert psender.can_fuse_jobs(pair(base))
    assert not psender.can_fuse_jobs(pair(base)[:1])
    assert not psender.can_fuse_jobs(
        [j + (1000,) for j in pair(base)])                    # a size budget
    jobs = pair(base)
    jobs[1][2].device = torch.device("cuda")
    assert not psender.can_fuse_jobs(jobs)
    base.two_pass = True
    assert not psender.can_fuse_jobs(pair(base))


class _Pipe:
    """A self-pipe end of the sender's: recv and send are no-ops."""

    def recv(self, n):
        return b"1"

    def send(self, data):
        return len(data)


def _choice_stub(mod, log):
    """A sender of ``mod`` with what handle_encodes_done and _send_output
    read and write, its log lines going to ``log``."""
    cls = mod.SalsifySender
    s = types.SimpleNamespace(
        _end_r=_Pipe(), _start_w=_Pipe(), _pending=None,
        avg_encoding_time=mod.AverageEncodingTime(), avg_delay=None,
        last_acked=None, cumulative_fpf=[], skipped_count=0, frame_no=0,
        frames_sent=0, last_quantizer=64, sent_log=[], pacer=mod.Pacer(),
        connection_id=1337, last_sent=time.monotonic(), encoders={},
        encoder_states=[], receiver_assumed_state=None,
        log_mem_usage=False, _log=log.append)
    for name in ("handle_encodes_done", "_send_output", "frame_budget"):
        if hasattr(cls, name):
            setattr(s, name, types.MethodType(getattr(cls, name), s))
    return s


def _control_output_choice():
    """handle_encodes_done's choice on seeded, scripted outputs and
    budgets, the real _send_output behind it: one output fits, both fit,
    none fits under MAX_SKIPPED (a skip), none fits at MAX_SKIPPED (the
    fail-small output sent all the same), a conventional frame that does
    not fit (skipped whatever the count), before and after the first ACK.
    The chosen job, quantizer, skip count, frame number and log lines
    equal the JAX package's after every step."""
    rng = np.random.default_rng(16)
    logs = ([], [])
    stubs = [_choice_stub(mod, log) for mod, log in zip((psender, jsender),
                                                        logs)]
    seen = set()
    for step in range(400):
        mode = "conventional" if rng.random() < 0.1 else "s2"
        delay = None if step < 3 else int(rng.integers(4000, 60_000))
        acked = int(rng.integers(0, 40))
        fpf = [acked + int(rng.integers(0, 6))] if step % 7 else []
        case = rng.choice(["one", "both", "none"], p=[0.3, 0.2, 0.5])
        budget = 5000       # before the first ACK every output fits
        if delay is not None:
            budget = psender.target_size(delay, acked,
                                         fpf[-1] if fpf else 0)
        else:
            case = "both"
        if case == "none" or budget == 0:
            case = "none"
            sizes = budget + 1 + rng.integers(0, 5000, 2)
        elif case == "both":
            sizes = rng.integers(1, budget + 1, 2)
        else:
            sizes = [int(rng.integers(1, budget + 1)),
                     budget + 1 + int(rng.integers(0, 5000))]
            rng.shuffle(sizes)
        names = ["frame"] if mode == "conventional" else \
            ["improve", "fail-small"]
        qis = [int(rng.integers(3, 128)) for _ in names]
        picked = []
        for s, mod in zip(stubs, (psender, jsender)):
            s.avg_delay, s.last_acked = delay, acked
            s.cumulative_fpf = list(fpf)
            s._pending = [mod.EncodeOutput(
                types.SimpleNamespace(minihash=lambda h=1000 + 2 * step + j: h,
                                      last_ssim=0.5 + j / 4),
                bytes(int(n)), 999, 7 + j, name, q)
                for j, (name, n, q) in enumerate(zip(names, sizes, qis))]
            sent = s.frames_sent
            assert s.handle_encodes_done() == mod.ResultType.Continue
            picked.append((s.frames_sent - sent, s.sent_log[-1][1:3]
                           if s.frames_sent > sent else None,
                           s.last_quantizer, s.skipped_count, s.frame_no,
                           s.receiver_assumed_state))
        assert picked[0] == picked[1], step
        assert logs[0] == logs[1], step
        seen.add("sent" if picked[0][0] else "skipped")
        if picked[0][0] and case == "none":
            seen.add("fail-small after %d skips" % psender.MAX_SKIPPED)
    assert {"sent", "skipped", "fail-small after %d skips"
            % psender.MAX_SKIPPED} <= seen
    assert any(l.startswith("too many skips") for l in logs[0])
    assert jsender.MAX_SKIPPED == psender.MAX_SKIPPED


def _control_traces(tmp_path):
    """lte_like_trace at three parameter sets (the default, the link of
    tests/test_net_emulation.py, chip_smoke.py's salsify_link) and
    load_mahimahi_trace on a trace file with blank lines equal the JAX
    package's."""
    from alfalfa_tpu.net import emulation as jemulation
    from alfalfa_tpu_torch.net import emulation
    import chip_smoke
    for kw in ({}, dict(ms_total=12000, period_ms=3000, high_pps=40,
                        low_pps=1), chip_smoke.SALSIFY_LINK_TRACE):
        got = emulation.lte_like_trace(**kw)
        assert got == jemulation.lte_like_trace(**kw) and got, kw
    rng = np.random.default_rng(17)
    path = tmp_path / "trace.txt"
    ms = np.cumsum(rng.integers(0, 5, 500)).tolist()
    path.write_text("".join("%d\n%s" % (t, "\n" if k % 50 == 0 else "")
                            for k, t in enumerate(ms)))
    got = emulation.load_mahimahi_trace(str(path))
    assert got == jemulation.load_mahimahi_trace(str(path)) == ms


CONTROL = {"quantizer_and_target_size": _control_quantizer_and_target,
           "averages": _control_averages, "update_cc": _control_update_cc,
           "state_selection": _control_state_selection,
           "can_fuse_jobs": _control_can_fuse,
           "output_choice": _control_output_choice,
           "traces": _control_traces}


# the cases added after the tier-1 clock filled up run under -m slow (a
# few seconds together): one more tier-1 item changes xdist's first
# chunks from 22 to 23 items, which replays 15 % slower
SLOW_CONTROL = ("output_choice", "traces")


@pytest.mark.parametrize("case", [
    pytest.param(c, marks=pytest.mark.slow) if c in SLOW_CONTROL else c
    for c in CONTROL])
def test_sender_control_matches_jax(case, tmp_path):
    """clamp_quantizer, target_size, the two EWMAs, the conventional
    mode's controller, the source-state bookkeeping, the choice of the
    output to send (or to skip) and the emulated link's traces equal the
    JAX package's on the same seeded sequences; can_fuse_jobs on the
    port's attributes."""
    if case == "traces":
        CONTROL[case](tmp_path)
    else:
        CONTROL[case]()


# -------------------------------------------------- (c) the receiver

def _stream(case):
    """[(frame_no, payload, source minihash, target minihash)] sent by a
    port encoder chain on the CPU, and the fragments to drop."""
    clip = gen_clip(W, H, 5, seed=9)
    enc = Encoder(W, H, quality="rt", fast=True, device="cpu")
    states = {enc.minihash(): enc}
    sent, prev = [], enc
    # frame 1 at qi 4 spans several fragments
    qis = (40, 4, 40, 40, 40)
    for n, f in enumerate(clip):
        src = prev
        if case == "state_switch" and n == 3:
            src = states[sent[1][3]]   # back to the state after frame 1
        if case == "dropped_tail" and n == 3:
            src = states[sent[0][3]]   # recover from the last state held
        e = src.fork()
        payload = e.encode_with_quantizer(f, qis[n])
        states[e.minihash()] = e
        sent.append((n, payload, src.minihash(), e.minihash()))
        prev = e
    drop = set()
    if case == "dropped_tail":
        last = -(-len(sent[1][1]) // 1400) - 1
        assert last >= 1
        drop = {(1, last)}
    return sent, drop


def _datagrams(mod, sent, drop):
    rng = np.random.default_rng(15)
    out, t = [], 1_000_000
    for n, payload, src, dst in sent:
        ff = mod.FragmentedFrame(1337, src, dst, n, 33_000 + 100 * n,
                                 whole_frame=payload)
        for p in ff.packets():
            t += int(rng.integers(200, 3000))
            if (n, p.fragment_no) not in drop:
                out.append((p.to_bytes(), t))
    return out


def _run_receiver(rcv, sock_mod, datagrams):
    shown, acks = [], []
    rcv.on_raster = shown.append
    queue = [sock_mod.Datagram(b, ("127.0.0.1", 4321), t)
             for b, t in datagrams]
    rcv.socket.recv = lambda *a: queue.pop(0)
    rcv.socket.sendto = lambda data, addr: acks.append(data)
    while queue:
        rcv.handle_packet()
    rcv.close()
    return [tuple(np.array(p) for p in r.display()) for r in shown], acks


@pytest.mark.parametrize("case", ["lossless", "dropped_tail",
                                  "state_switch"])
def test_receiver_matches_jax(case):
    """The port's and the JAX package's SalsifyReceiver on the same
    scripted datagrams (kernel RX times included): the same displayed
    rasters, current and complete states, next frame and ACK bytes.
    dropped_tail loses frame 1's last fragment (frame 1 concealed from
    its prefix when frame 2 arrives) and recovers from the state after
    frame 0; state_switch encodes frame 3 against the state after frame 1,
    which the receiver restores from its held decoders."""
    sent, drop = _stream(case)
    got = []
    for mod, rmod, smod, kw in (
            (net, preceiver, psocket, {"device": "cpu"}),
            (jnet, jreceiver, jsocket, {"backend": "numpy"})):
        rcv = rmod.SalsifyReceiver(0, W, H, host="127.0.0.1", **kw)
        shown, acks = _run_receiver(rcv, smod, _datagrams(mod, sent, drop))
        got.append((shown, acks, rcv.current_state,
                    list(rcv.complete_states), rcv.next_frame_no,
                    sorted(rcv.decoders)))
    (mshown, macks, *mine), (jshown, jacks, *theirs) = got
    assert mine == theirs
    assert macks == jacks and len(macks) == len(_datagrams(net, sent, drop))
    # dropped_tail shows frame 1 too, concealed
    assert len(mshown) == len(jshown) == len(sent)
    for a, b in zip(mshown, jshown):
        for pa, pb in zip(a, b):
            assert np.array_equal(pa, pb)
    if case != "dropped_tail":
        assert mine[0] == sent[-1][3]


# -------------------------------------------------- (d) loopback

class ClipInput(FrameInput):
    def __init__(self, clip, width, height):
        self.clip = list(clip)
        self.i = 0
        self.w, self.h = width, height

    def get_next_frame(self):
        if self.i >= len(self.clip):
            return None
        f = self.clip[self.i]
        self.i += 1
        return f

    @property
    def display_width(self):
        return self.w

    @property
    def display_height(self):
        return self.h


def run_pair(drop_fragments=(), mode="s2", expect_frames=N_FRAMES,
             width=W, height=H, seed=5, on_sender=None):
    """tests/test_salsify.py's run_pair through the port on the CPU, on an
    ephemeral port; returns (sender, receiver, received rasters)."""
    clip = gen_clip(width, height, N_FRAMES, seed=seed)
    received = []
    receiver = preceiver.SalsifyReceiver(0, width, height, host="127.0.0.1",
                                         on_raster=received.append,
                                         device="cpu")
    port = receiver.socket.getsockname()[1]
    dropped = set()
    if drop_fragments:
        real_recv = receiver.socket.recv

        def lossy_recv(*a, **kw):
            while True:
                d = real_recv(*a, **kw)
                p = net.Packet.parse(d.payload)
                key = (p.frame_no, p.fragment_no)
                if key in drop_fragments and key not in dropped:
                    dropped.add(key)
                    continue
                return d
        receiver.socket.recv = lossy_recv

    def serve():
        try:
            receiver.run(max_frames=expect_frames, timeout_ms=60000)
        except (OSError, ValueError):
            pass                # its socket closed under it (below)

    rt = threading.Thread(target=serve, daemon=True)
    rt.start()
    source = ClipInput(clip, width, height)
    sender = psender.SalsifySender("127.0.0.1", port, 1337, source,
                                   mode=mode, drop_frames_while_busy=False,
                                   device="cpu")
    if on_sender is not None:
        on_sender(sender, source)
    try:
        sender.run(max_frames=N_FRAMES)
        # let in-flight datagrams land: every frame sent is displayed but
        # one that lost its fragment 0 (its prefix is empty), or the
        # receiver exits at expect_frames
        shown = sender.frames_sent - sum(f == 0 for _, f in dropped)
        deadline = time.monotonic() + 30
        while rt.is_alive() and len(received) < shown \
                and time.monotonic() < deadline:
            rt.join(0.1)
    finally:
        sender.close()
        receiver.close()
    return sender, receiver, received


def _lossless_s2():
    sender, receiver, received = run_pair()
    assert sender.frames_sent == N_FRAMES
    assert len(received) == N_FRAMES
    assert receiver.current_state == sender.receiver_assumed_state
    assert sender.receiver_last_acked_state is not None
    assert sender.avg_delay is not None
    assert receiver.complete_states
    for s in receiver.complete_states:
        assert s in receiver.decoders


def _lossless_s1_content():
    sender, receiver, received = run_pair(mode="s1")
    assert len(received) == N_FRAMES
    last_encoder = sender.encoders[sender.receiver_assumed_state]
    for e, r in zip(last_encoder.references.last.display(),
                    received[-1].display()):
        assert np.array_equal(e, r)


def _lossy_concealment():
    sender, receiver, received = run_pair(drop_fragments={(2, 0)},
                                          expect_frames=N_FRAMES - 1)
    assert sender.frames_sent >= 3
    assert len(received) >= sender.frames_sent - 2
    assert receiver.next_frame_no >= 3


def _conventional():
    sender, receiver, received = run_pair(mode="conventional")
    assert sender.frames_sent == N_FRAMES
    assert len(received) == N_FRAMES


LOOPBACK = {"lossless_s2": _lossless_s2,
            "lossless_s1_content": _lossless_s1_content,
            "lossy_concealment": _lossy_concealment,
            "conventional": _conventional}


@pytest.mark.parametrize("case", list(LOOPBACK))
def test_loopback(case):
    """tests/test_salsify.py's four cases through the port's sender and
    receiver on loopback UDP, with the same assertions."""
    LOOPBACK[case]()


@pytest.mark.slow
@pytest.mark.parametrize("delay_ms", [20, 200])
def test_salsify_over_emulated_link(delay_ms):
    """tests/test_net_emulation.py through the port on the CPU, at its size,
    trace, queue and gates (the stream survives the capacity dips; frames
    sent while the ACK-measured delay is high are smaller), on ephemeral
    ports: at its 20 ms one-way delay, and at 200 ms, where the budget
    also has to bind: at least one frame is skipped.  At 200 ms a frame
    stays in flight longer than a 64x48 encode takes on a busy host, so in
    a dip (one packet a 100 ms) the budget is spent whatever the host's
    speed; at 20 ms a slow host sees every frame acknowledged before its
    next encode ends and may skip none."""
    from alfalfa_tpu_torch.net.emulation import EmulatedLink, lte_like_trace
    n = 80
    clip = list(gen_clip(W, H, 12, seed=9)) * (n // 12 + 1)
    received = []
    receiver = preceiver.SalsifyReceiver(0, W, H, host="127.0.0.1",
                                         on_raster=received.append,
                                         device="cpu")
    trace = lte_like_trace(ms_total=12000, period_ms=3000, high_pps=40,
                           low_pps=1)
    link = EmulatedLink(0, receiver.socket.getsockname()[1], trace,
                        delay_ms=delay_ms, queue_limit=32).start()

    def serve():
        try:
            receiver.run(max_frames=n, timeout_ms=60000)
        except (OSError, ValueError):
            pass                # its socket closed under it (below)

    rt = threading.Thread(target=serve, daemon=True)
    rt.start()
    sender = psender.SalsifySender("127.0.0.1", link.listen_port, 1337,
                                   ClipInput(clip, W, H), mode="s2",
                                   drop_frames_while_busy=False,
                                   device="cpu")
    lines = []
    sender._log = lines.append
    try:
        sender.run(max_frames=n)
        # an encode still running for the next frame ends before the
        # sender closes
        deadline = time.monotonic() + 30
        while sender._pending == [] and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.05)
        deadline = time.monotonic() + 20
        while rt.is_alive() and time.monotonic() < deadline and \
                len(received) < n // 2:
            rt.join(0.1)
    finally:
        sender.close()
        receiver.close()
        link.close()

    assert len(received) >= n // 2, f"only {len(received)} frames arrived"
    assert link.stats["delivered"] > 0 and link.stats["acks"] > 0
    if delay_ms == 200:
        assert any(l.startswith("skipping frame") for l in lines)
    log = [(size, delay) for _, size, delay, _, _ in sender.sent_log
           if delay is not None]
    assert len(log) >= 20, "too few delay-informed sends to judge adaptation"
    sizes = np.array([v for v, _ in log], float)
    delays = np.array([d for _, d in log], float)
    hi = delays > np.median(delays)
    assert hi.any() and (~hi).any()
    assert sizes[hi].mean() < sizes[~hi].mean(), (
        f"no adaptation: mean size at high delay {sizes[hi].mean():.0f} >= "
        f"{sizes[~hi].mean():.0f} at low delay")
    corr = float(np.corrcoef(sizes, delays)[0, 1])
    assert corr < -0.2, f"size/delay correlation too weak: {corr:.2f}"


# --------------------------------------------- (e) payloads by replay

def test_loopback_payloads_replay_through_jax_fast_path():
    """A lossless s2 loopback of the port at 80x48 (the key frame's two
    jobs in two threads, then the fused fast pair), each sent frame's
    source state, job, quantizer, payload and target state logged; the log
    replayed through JAX encoders keyed by minihash (the key frame on the
    host, then the JAX fast path's single encodes) gives every payload and
    every minihash again.  The port's fused pair equals its single encodes
    (test_torch_fast_inter.py), so single JAX encodes are the reference."""
    from test_torch_fast_inter import jax_fast_path
    from alfalfa_tpu.encoder import Encoder as JEncoder

    w, h = 80, 48
    log = []

    def on_sender(sender, source):
        send = sender._send_output

        def logged(output):
            log.append((source.i - 1, output.source_minihash, output.job_name,
                        output.y_ac_qi, bytes(output.frame),
                        output.encoder.minihash()))
            return send(output)
        sender._send_output = logged

    sender, _, received = run_pair(width=w, height=h, seed=31,
                                   on_sender=on_sender)
    assert sender.frames_sent == N_FRAMES == len(log) == len(received)
    assert [k for k, *_ in log] == list(range(N_FRAMES))
    assert {j for _, _, j, *_ in log} <= {"improve", "fail-small"}
    clip = gen_clip(w, h, N_FRAMES, seed=31)
    base = JEncoder(w, h, quality="rt", device_encode=False)
    jencs = {base.minihash(): base}
    assert log[0][1] == base.minihash()
    with jax_fast_path((h + 15) // 16, (w + 15) // 16):
        for k, source, _job, qi, payload, target in log:
            enc = jencs[source].fork()
            assert enc.encode_with_quantizer(clip[k], qi) == payload, \
                "frame %d differs" % k
            enc.device_encode = True    # interframes: the fast path
            assert enc.minihash() == target
            jencs[target] = enc


# ------------------------------------------------------- (f) the CLI

def test_xc_run_contest_help(capsys):
    with pytest.raises(SystemExit) as e:
        xc.main(["run-contest", "--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "--trace" in out and "--device" in out


def test_xc_run_contest_runs(tmp_path, capsys):
    """6 frames at 64x48 through the default synthetic LTE-like trace,
    the encoders and the decoder on the CPU."""
    path = str(tmp_path / "in.y4m")
    w = Y4MWriter(path, W, H)
    for f in gen_clip(W, H, N_FRAMES, seed=5):
        w.append_frame(*f)
    w.close()
    assert xc.main(["run-contest", "--device", "cpu", "--frames",
                    str(N_FRAMES), path]) is None
    out = capsys.readouterr().out
    line = [l for l in out.splitlines() if l.startswith("sent ")]
    assert line and line[0].startswith("sent %d frames, received " % N_FRAMES)
    assert int(line[0].split("received ")[1].split(",")[0]) >= 1
    assert "link: {" in out


def test_receiver_close_ends_run():
    """close() from another thread stops a run() that would poll forever,
    waits for it, then closes the socket: the thread ends with run()'s 0
    and no exception (xc run-contest closes its receiver this way)."""
    rcv = preceiver.SalsifyReceiver(0, W, H, host="127.0.0.1", device="cpu")
    result = []

    def run():
        try:
            result.append(rcv.run())
        except BaseException as e:      # noqa: BLE001 - the test's subject
            result.append(e)

    t = threading.Thread(target=run)
    t.start()
    time.sleep(0.3)                     # run() is polling now
    t0 = time.monotonic()
    rcv.close()
    assert not t.is_alive()
    assert time.monotonic() - t0 < 2
    assert result == [0]
    assert rcv.socket.fileno() == -1
    rcv.close()                         # a second close is harmless
