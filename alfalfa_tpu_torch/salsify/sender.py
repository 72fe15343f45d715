"""Salsify sender (reference src/salsify/salsify-sender.cc:61-717).

Event loop: grab a frame, pick a source state the receiver is believed to
hold, encode speculatively at two quantizers ("improve" at q-17 and
"fail-small" at q+23), pick the largest output that fits the network's
instantaneous capacity (1400 B x packets the 100 ms budget still allows),
fragment + pace it out, and track receiver state from ACKs.

Modes: "s2" (both speculative encodes in parallel threads), "s1" (lazy
second encode), "conventional" (single encode, AIMD-ish quantizer control).

The encoders run on ``device`` (default CUDA).  With ``fast=True`` (the
default) an interframe goes through the fast rt path (K9, K3, K10, K5),
and from frame 1 on the s2 pair is one fused call over both quantizers;
``fast=False`` encodes through K8.  The key frame's two jobs run in two
threads (K7 twice); their launches serialise on the default stream.
"""
import socket as _socket
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from alfalfa_tpu_torch.encoder import Encoder
from alfalfa_tpu_torch.net import (AckPacket, FragmentedFrame, Pacer, Poller,
                             Action, Direction, ResultType, UDPSocket)

MAX_SKIPPED = 3           # sender.cc:276
CONSERVATIVE_FOR_S = 5.0  # sender.cc:319
MAX_DELAY_US = 100_000    # the 100 ms in-flight budget (sender.cc:160-170)


def clamp_quantizer(q, inc=0):
    """sender.cc increment_quantizer: clamp to [3, 127]."""
    return max(3, min(127, int(q) + inc))


def target_size(avg_delay, last_acked, last_sent, max_delay=MAX_DELAY_US):
    """Instantaneous network capacity estimate (sender.cc:160-170):
    how many more 1400-byte packets fit in the 100 ms budget, given the
    receiver-reported inter-packet delay and the packets still in flight."""
    avg_delay = max(1, avg_delay)
    return 1400 * max(0, max_delay // avg_delay - (last_sent - last_acked))


class AverageEncodingTime:
    """EWMA of inter-encode intervals (sender.cc:61-89)."""
    ALPHA = 0.1

    def __init__(self):
        self.value = -1.0
        self.last_update_us = 0

    def add(self, timestamp_us):
        if self.value < 0 or timestamp_us - self.last_update_us > 1_000_000:
            self.value = 0.0
        else:
            new_value = max(0, timestamp_us - self.last_update_us)
            self.value = self.ALPHA * new_value + (1 - self.ALPHA) * self.value
        self.last_update_us = timestamp_us

    def int_value(self):
        return int(self.value)


class EncodeOutput:
    __slots__ = ("encoder", "frame", "source_minihash", "encode_time_ms",
                 "job_name", "y_ac_qi")

    def __init__(self, encoder, frame, source_minihash, encode_time_ms,
                 job_name, y_ac_qi):
        self.encoder = encoder
        self.frame = frame
        self.source_minihash = source_minihash
        self.encode_time_ms = encode_time_ms
        self.job_name = job_name
        self.y_ac_qi = y_ac_qi


def do_encode_job(name, raster, encoder, y_ac_qi, target_size_bytes=None):
    """One speculative encode (sender.cc:128-158): constant-quantizer, or
    TARGET_FRAME_SIZE when a byte budget is given."""
    source_minihash = encoder.minihash()
    t0 = time.monotonic()
    if target_size_bytes is not None:
        output = encoder.encode_with_target_size(raster, target_size_bytes)
        q_used = encoder.last_y_ac_qi
    else:
        output = encoder.encode_with_quantizer(raster, y_ac_qi)
        q_used = y_ac_qi
    ms = int((time.monotonic() - t0) * 1000)
    return EncodeOutput(encoder, output, source_minihash, ms, name, q_used)


def can_fuse_jobs(jobs):
    """True when both speculative encodes can share one device dispatch:
    interframes at plain quantizers from identically-forked one-pass
    encoders on one device (SURVEY section 7.1: the speculative pair is a
    QP axis, not two processes)."""
    return (len(jobs) == 2
            and all(len(j) == 4 for j in jobs)
            and jobs[0][2].device == jobs[1][2].device
            and all(j[2].frame_no > 0 for j in jobs)
            and all(not j[2].two_pass for j in jobs))


def do_encode_jobs_fused(jobs):
    """Both speculative encodes in ONE device dispatch: the quantizer is a
    grid axis of each kernel, so the fast path's decisions (K9),
    prediction (K3) and intra fixup (K10), or K8's whole macroblock loop,
    serve 'improve' and 'fail-small' in one launch each, from one plane
    upload (salsify-sender.cc:490-518 runs them as two threads).  The
    multiqp functions leave ``frame_no``, ``last_y_ac_qi`` and
    ``last_ssim`` to their caller, as encode_with_quantizer sets them."""
    from alfalfa_tpu_torch.bitstream.header import QuantIndices
    from alfalfa_tpu_torch.encoder import encode_inter, encode_inter_fast

    raster = jobs[0][1]
    encoders = [j[2] for j in jobs]
    qis = [j[3] for j in jobs]
    source_minihash = encoders[0].minihash()
    t0 = time.monotonic()
    fused = encode_inter.encode_interframe_multiqp
    if all(e.fast and e.quality == "rt" for e in encoders):
        fused = encode_inter_fast.encode_interframe_fast_multiqp
    results = fused(
        encoders, raster, [QuantIndices(y_ac_qi=int(q)) for q in qis])
    ms = int((time.monotonic() - t0) * 1000)
    outs = []
    for (name, _r, enc, qq), (payload, q_ssim) in zip(jobs, results):
        enc.frame_no += 1
        enc.last_y_ac_qi = int(qq)
        enc.last_ssim = q_ssim
        outs.append(EncodeOutput(enc, payload, source_minihash, ms, name,
                                 int(qq)))
    return outs


class SalsifySender:
    def __init__(self, host, port, connection_id, frame_input,
                 mode="s2", update_rate=1, verbose=False,
                 drop_frames_while_busy=True, log_mem_usage=False,
                 device=None, fast=True):
        self.socket = UDPSocket()
        self.socket.connect(host, port)
        self.socket.set_timestamps()
        self.connection_id = int(connection_id)
        self.frame_input = frame_input
        self.mode = mode
        self.verbose = verbose
        # realtime (camera) semantics: keep draining the source while an
        # encode is in flight, dropping the grabbed frames (sender.cc:342-350).
        # False = lossless file-input mode: hold the frame until we're free.
        self.drop_frames_while_busy = drop_frames_while_busy

        w, h = frame_input.display_width, frame_input.display_height
        # real-time budget (33 ms at 720p, salsify-sender.cc:160-170):
        # the interframes take the fast path (encoder/encode_inter_fast.py)
        # unless fast=False, which keeps them on K8
        base_encoder = Encoder(w, h, quality="rt", device=device, fast=fast)
        self.initial_state = base_encoder.minihash()
        self.encoders = {self.initial_state: base_encoder}
        self.encoder_states = []          # insertion-ordered minihashes
        self.pacer = Pacer()

        self.avg_delay = None             # from ACKs (us)
        self.sent_log = []                # (frame_no, bytes, avg_delay, t)
        self.cumulative_fpf = []          # fragments-per-frame, cumulative
        self.last_acked = None
        self.skipped_count = 0
        self.frame_no = 0
        self.last_quantizer = 64
        self.avg_encoding_time = AverageEncodingTime()

        self.receiver_last_acked_state = None
        self.receiver_assumed_state = None
        self.receiver_complete_states = []
        self.conservative_until = time.monotonic()
        self.last_sent = time.monotonic()

        # conventional-mode congestion controller (sender.cc:323-327)
        self.cc_quantizer = 32
        self.cc_rate_ewma = 0
        self.cc_update_interval = (1.0 / update_rate) if update_rate else 0.0
        self.next_cc_update = time.monotonic() + self.cc_update_interval

        self.frames_sent = 0
        self.log_mem_usage = log_mem_usage
        self._next_mem_report = time.monotonic()
        self._executor = ThreadPoolExecutor(max_workers=2)
        self._pending = None              # in-flight encode futures
        # self-pipe pair to signal "grab next frame" / "encodes done"
        self._start_r, self._start_w = _socket.socketpair()
        self._end_r, self._end_w = _socket.socketpair()

    # -- state selection (sender.cc:383-441) -----------------------------------

    def select_source_state(self):
        now = time.monotonic()
        if now < self.conservative_until:
            if not self.receiver_complete_states:
                return self.initial_state
            return self.receiver_complete_states[-1]
        if self.receiver_last_acked_state is None:
            if self.receiver_assumed_state is None:
                return self.initial_state
            return self.receiver_assumed_state
        if self.receiver_last_acked_state not in self.encoders:
            # receiver is in a state we no longer have: conservative mode
            self.conservative_until = now + CONSERVATIVE_FOR_S
            self._log(f"going conservative for {CONSERVATIVE_FOR_S:.0f}s")
            if not self.receiver_complete_states:
                return self.initial_state
            return self.receiver_complete_states[-1]
        return self.receiver_assumed_state

    def prune_encoders(self):
        """Drop encoders older than the last acked state (sender.cc:357-379)."""
        acked = self.receiver_last_acked_state
        if (acked is None or acked == self.initial_state
                or acked not in self.encoders):
            return
        cut = 0
        for i, s in enumerate(self.encoder_states):
            if s == acked or s == self.receiver_assumed_state:
                cut = i
                break
            if s not in self.encoder_states[i + 1:]:
                self.encoders.pop(s, None)
            cut = i + 1
        del self.encoder_states[:cut]

    # -- per-frame pipeline -----------------------------------------------------

    def handle_new_frame(self):
        self._start_r.recv(1)
        if self._pending is not None and not self.drop_frames_while_busy:
            return ResultType.Continue  # hold the frame until we're free
        raster = self.frame_input.get_next_frame()
        if raster is None:
            self._flush_pacer_blocking()
            return ResultType.Exit
        if self._pending is not None:
            return ResultType.Continue  # an encode is already running

        self.prune_encoders()
        source_hash = self.select_source_state()
        encoder = self.encoders[source_hash]

        if self.mode == "conventional":
            self._update_cc()
            jobs = [("frame", raster, encoder.fork(), self.cc_quantizer)]
        else:
            jobs = [("improve", raster, encoder.fork(),
                     clamp_quantizer(self.last_quantizer, -17)),
                    ("fail-small", raster, encoder.fork(),
                     clamp_quantizer(self.last_quantizer, +23))]

        def run_jobs(jobs=jobs):
            if self.mode == "s2" and can_fuse_jobs(jobs):
                outputs = do_encode_jobs_fused(jobs)
            elif self.mode == "s2":
                futures = [self._executor.submit(do_encode_job, *j) for j in jobs]
                outputs = [f.result() for f in futures]
            else:  # s1 / conventional: sequential ("deferred") encode
                outputs = [do_encode_job(*j) for j in jobs]
            self._pending = outputs
            self._end_w.send(b"1")

        self._pending = []
        threading.Thread(target=run_jobs, daemon=True).start()
        return ResultType.Continue

    def _update_cc(self):
        """Conventional-mode quantizer controller (sender.cc:452-488)."""
        now = time.monotonic()
        if now < self.next_cc_update or self.avg_delay is None:
            return
        cc_rate = 1_000_000 * 1400 // max(1, self.avg_delay)
        if self.cc_rate_ewma:
            change = (cc_rate - self.cc_rate_ewma) / self.cc_rate_ewma
        else:
            change = 0.0
        change = max(-1.0, min(1.5, change))
        if change < -0.99:
            self.cc_quantizer = 127
        else:
            qalpha = 0.75
            self.cc_quantizer = clamp_quantizer(
                self.cc_quantizer / ((change + 1) ** (1 / qalpha)))
        self.cc_rate_ewma = int(0.8 * cc_rate + 0.2 * self.cc_rate_ewma)
        self.next_cc_update = now + self.cc_update_interval

    def handle_encodes_done(self):
        self._end_r.recv(1)
        outputs, self._pending = self._pending, None
        try:
            self.avg_encoding_time.add(int(time.monotonic() * 1e6))
            if not outputs:
                return ResultType.Continue

            # effectively-unbounded budget until the first ACK teaches us
            # the path capacity (must stay an int: inf-x < inf is never true)
            frame_size = 1 << 62
            if self.avg_delay is not None:
                frame_size = target_size(self.avg_delay,
                                         self.last_acked or 0,
                                         self.cumulative_fpf[-1]
                                         if self.cumulative_fpf else 0)

            # largest output that fits (sender.cc:565-580)
            best = None
            best_diff = 1 << 63
            for out in outputs:
                if len(out.frame) <= frame_size and \
                        frame_size - len(out.frame) < best_diff:
                    best_diff = frame_size - len(out.frame)
                    best = out
            if best is None:
                if (self.skipped_count < MAX_SKIPPED
                        or outputs[-1].job_name != "fail-small"):
                    self._log(f"skipping frame {self.frame_no}")
                    self.skipped_count += 1
                    return ResultType.Continue
                self._log(f"too many skips; sending bad-quality frame "
                          f"{self.frame_no}")
                best = outputs[-1]

            self._send_output(best)
            return ResultType.Continue
        finally:
            self._start_w.send(b"1")  # kick the next frame grab

    def _send_output(self, output):
        target_minihash = output.encoder.minihash()
        self.last_quantizer = output.y_ac_qi
        self.sent_log.append((self.frame_no, len(output.frame),
                              self.avg_delay, time.monotonic(),
                              output.encode_time_ms))

        now = time.monotonic()
        ff = FragmentedFrame(self.connection_id, output.source_minihash,
                             target_minihash, self.frame_no,
                             int((now - self.last_sent) * 1e6),
                             whole_frame=output.frame)
        # send 5x faster than packets are being received (sender.cc:616)
        inter_send_delay = min(2000, max(500, (self.avg_delay or 10000) // 5))
        for packet in ff.packets():
            self.pacer.push(packet.to_bytes(), inter_send_delay)
        self.last_sent = now

        prev = self.cumulative_fpf[-1] if self.cumulative_fpf else 0
        self.cumulative_fpf.append(prev + ff.fragments_in_this_frame)

        self.receiver_assumed_state = target_minihash
        self.encoders[target_minihash] = output.encoder
        self.encoder_states.append(target_minihash)
        self.skipped_count = 0
        if self.log_mem_usage and time.monotonic() >= self._next_mem_report:
            # sender.cc:634-637: RSS report every 5s
            from alfalfa_tpu_torch.util.procinfo import memory_usage
            print(f"<mem = {memory_usage()}>", file=sys.stderr)
            self._next_mem_report = time.monotonic() + 5.0
        # per-frame line incl. the encode SSIM (sender.cc:627-637)
        q_ssim = getattr(output.encoder, "last_ssim", None)
        self._log(f"frame {self.frame_no}: {output.job_name} "
                  f"(q={output.y_ac_qi}, "
                  f"ssim={-1.0 if q_ssim is None else q_ssim:.4f}) = "
                  f"{ff.fragments_in_this_frame} fragments, "
                  f"{output.encode_time_ms} ms "
                  f"{{{output.source_minihash:#x} -> {target_minihash:#x}}}")
        self.frame_no += 1
        self.frames_sent += 1

    # -- ack handling (sender.cc:658-685) ---------------------------------------

    def _ack_seq_no(self, ack):
        if ack.frame_no > 0 and ack.frame_no - 1 < len(self.cumulative_fpf):
            return self.cumulative_fpf[ack.frame_no - 1] + ack.fragment_no
        return ack.fragment_no

    def handle_ack(self):
        datagram = self.socket.recv()
        ack = AckPacket.parse(datagram.payload)
        if ack.connection_id != self.connection_id:
            return ResultType.Continue
        seq = self._ack_seq_no(ack)
        if self.last_acked is not None and seq < self.last_acked:
            return ResultType.Continue
        self.last_acked = seq
        self.avg_delay = ack.avg_delay
        self.receiver_last_acked_state = ack.current_state
        self.receiver_complete_states = list(ack.complete_states)
        return ResultType.Continue

    # -- main loop ---------------------------------------------------------------

    def run(self, max_frames=None):
        poller = Poller()
        poller.add_action(Action(self._start_r, Direction.In,
                                 self.handle_new_frame))
        poller.add_action(Action(self._end_r, Direction.In,
                                 self.handle_encodes_done))
        poller.add_action(Action(self.socket, Direction.In, self.handle_ack))
        poller.add_action(Action(
            self.socket, Direction.Out, self._drain_pacer,
            when_interested=lambda: self.pacer.ms_until_due() == 0
                                    and not self.pacer.empty()))
        self._start_w.send(b"1")
        while max_frames is None or self.frames_sent < max_frames \
                or not self.pacer.empty():
            result = poller.poll(self.pacer.ms_until_due())
            if result.result == result.Type.Exit:
                return result.exit_status
        return 0

    def _drain_pacer(self):
        while not self.pacer.empty() and self.pacer.ms_until_due() == 0:
            self.socket.send(self.pacer.front())
            self.pacer.pop()
        return ResultType.Continue

    def _flush_pacer_blocking(self):
        """Honor pacing for whatever is still queued before exiting."""
        while not self.pacer.empty():
            time.sleep(self.pacer.ms_until_due() / 1000)
            self._drain_pacer()

    def _log(self, msg):
        if self.verbose:
            print(f"[sender] {msg}", file=sys.stderr)

    def close(self):
        self._executor.shutdown(wait=False)
        for s in (self._start_r, self._start_w, self._end_r, self._end_w):
            s.close()
        self.socket.close()


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(
        prog="salsify-sender",
        description="Salsify real-time sender (salsify-sender.cc)")
    parser.add_argument("host")
    parser.add_argument("port")
    parser.add_argument("connection_id", type=int)
    parser.add_argument("-m", "--mode", default="s2",
                        choices=["s1", "s2", "conventional"])
    parser.add_argument("-d", "--device", default="/dev/video0")
    parser.add_argument("-p", "--pixfmt", default="NV12")
    parser.add_argument("-u", "--update-rate", type=int, default=1)
    parser.add_argument("-i", "--input", default=None,
                        help="y4m file instead of a camera ('-' for stdin)")
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument("--log-mem-usage", action="store_true")
    parser.add_argument("--torch-device", default="cuda",
                        help="torch device of the encoders")
    args = parser.parse_args(argv)

    if args.input is not None:
        from alfalfa_tpu_torch.input import YUV4MPEGInput
        src = YUV4MPEGInput(sys.stdin.buffer if args.input == "-" else args.input)
    else:
        from alfalfa_tpu_torch.input import Camera
        src = Camera(args.device, pixel_format=args.pixfmt)

    sender = SalsifySender(args.host, args.port, args.connection_id, src,
                           mode=args.mode, update_rate=args.update_rate,
                           verbose=args.verbose,
                           log_mem_usage=args.log_mem_usage,
                           device=args.torch_device)
    try:
        return sender.run()
    finally:
        sender.close()


if __name__ == "__main__":
    sys.exit(main())
