"""Salsify receiver (reference src/salsify/salsify-receiver.cc:98-342).

Reassembles fragments into frames; when a packet for frame n+1 arrives
before frame n completes, the partial frame is decoded with error
concealment and the stream moves on.  Keeps a minihash-addressed map of
complete decoder states so the sender can encode against any acked state.
ACKs every packet with the inter-packet-delay EWMA and the held states.

Frames are reconstructed on ``device`` (default CUDA) by the port's
``FramePlayer``; the held decoders are ``Decoder.copy()`` values that
share their rasters (and one pinned upload buffer: decoding stays on one
thread, the receiver's).
"""
import sys
import threading

from alfalfa_tpu_torch.decoder import FramePlayer
from alfalfa_tpu_torch.net import (AckPacket, FragmentedFrame, Packet, Poller,
                             Action, Direction, ResultType, UDPSocket)


class AverageInterPacketDelay:
    """EWMA over kernel RX timestamps, minus the sender's intentional
    inter-send gap (salsify-receiver.cc:55-83)."""
    ALPHA = 0.1

    def __init__(self):
        self.value = -1.0
        self.last_update_us = 0

    def add(self, timestamp_us, grace_us):
        if self.value < 0:
            self.value = 0.0
        else:
            new_value = max(0, timestamp_us - self.last_update_us - grace_us)
            self.value = self.ALPHA * new_value + (1 - self.ALPHA) * self.value
        self.last_update_us = timestamp_us

    def int_value(self):
        return int(self.value)


# the longest single poll of SalsifyReceiver.run, and so the longest that
# close() waits on an idle socket
_STOP_POLL_MS = 100


class SalsifyReceiver:
    def __init__(self, port, width, height, connection_id=1337,
                 on_raster=None, verbose=False, host="0.0.0.0",
                 device=None):
        self.socket = UDPSocket()
        self.socket.bind(host, port)
        self.socket.set_timestamps()
        self.connection_id = int(connection_id)
        self.verbose = verbose
        self.on_raster = on_raster  # display hook: called with each raster

        self.player = FramePlayer(width, height, device=device)
        self.player.set_error_concealment(True)

        self.fragmented_frames = {}  # frame_no -> FragmentedFrame
        self.next_frame_no = 0
        self.avg_delay = AverageInterPacketDelay()

        self.current_state = self.player.current_decoder().minihash()
        self.initial_state = self.current_state
        self.complete_states = []
        self.decoders = {self.current_state: self.player.current_decoder().copy()}
        self.frames_displayed = 0
        # run() reads the flag before each poll; close() sets it and
        # waits for run() before the socket goes
        self._stop = threading.Event()
        self._runner = None

    def _display(self, payload):
        """Decode and hand the raster to the display hook
        (enqueue_frame, salsify-receiver.cc:117-135)."""
        if not payload:
            return
        raster = self.player.decode(payload)
        if raster is not None:
            self.frames_displayed += 1
            if self.on_raster is not None:
                self.on_raster(raster)

    def handle_packet(self):
        datagram = self.socket.recv()
        packet = Packet.parse(datagram.payload)

        if packet.frame_no < self.next_frame_no:
            return ResultType.Continue  # stale

        if packet.frame_no > self.next_frame_no:
            # a later frame started: flush earlier partial frames with
            # concealment and move on (receiver.cc:225-245)
            self._log(f"packet for frame {packet.frame_no}; displaying "
                      f"partial frame(s) from {self.next_frame_no}")
            for i in range(self.next_frame_no, packet.frame_no):
                ff = self.fragmented_frames.pop(i, None)
                if ff is not None:
                    self._display(ff.partial_frame())
            self.next_frame_no = packet.frame_no
            self.current_state = self.player.current_decoder().minihash()

        if packet.frame_no in self.fragmented_frames:
            self.fragmented_frames[packet.frame_no].add_packet(packet)
        else:
            self.fragmented_frames[packet.frame_no] = FragmentedFrame(
                self.connection_id, packet=packet)

        ff = self.fragmented_frames.get(self.next_frame_no)
        if ff is not None and ff.complete():
            expected_source = ff.source_state
            if self.current_state != expected_source and \
                    expected_source in self.decoders:
                # restore the decoder the sender encoded against
                self.player.set_decoder(self.decoders[expected_source].copy())
                self.current_state = expected_source

            if self.current_state == expected_source and \
                    expected_source != self.initial_state:
                # the sender won't reference older states; drop them
                # (receiver.cc:252-268)
                idx = None
                for i, s in enumerate(self.complete_states):
                    if s == expected_source:
                        idx = i
                        break
                    self.decoders.pop(s, None)
                if idx is not None:
                    del self.complete_states[:idx]

            self._display(ff.frame())
            self.current_state = self.player.current_decoder().minihash()

            if self.current_state == ff.target_state and \
                    self.current_state != self.initial_state:
                # decode landed exactly on the advertised state: keep it
                self.decoders[self.current_state] = \
                    self.player.current_decoder().copy()
                self.complete_states.append(self.current_state)

            del self.fragmented_frames[self.next_frame_no]
            self.next_frame_no += 1

        self.avg_delay.add(datagram.timestamp_us, packet.time_since_last)
        ack = AckPacket(self.connection_id, packet.frame_no,
                        packet.fragment_no, self.avg_delay.int_value(),
                        self.current_state, self.complete_states)
        self.socket.sendto(ack.to_bytes(), datagram.source_address)
        return ResultType.Continue

    def run(self, max_frames=None, timeout_ms=-1):
        """Receive until ``max_frames`` are displayed, ``timeout_ms`` pass
        without a packet (never if negative), or close() is called.  The
        polls last at most _STOP_POLL_MS each, so close() never waits on
        an idle socket."""
        poller = Poller()
        poller.add_action(Action(self.socket, Direction.In,
                                 self.handle_packet))
        self._runner = threading.current_thread()
        idle_ms = 0
        try:
            while (max_frames is None
                   or self.frames_displayed < max_frames):
                if self._stop.is_set():
                    return 0
                step = _STOP_POLL_MS if timeout_ms < 0 else \
                    min(_STOP_POLL_MS, timeout_ms - idle_ms)
                result = poller.poll(step)
                if result.result == result.Type.Exit:
                    return result.exit_status
                if result.result != result.Type.Timeout:
                    idle_ms = 0
                elif timeout_ms >= 0:
                    idle_ms += step
                    if idle_ms >= timeout_ms:
                        return 0
            return 0
        finally:
            self._runner = None

    def _log(self, msg):
        if self.verbose:
            print(f"[receiver] {msg}", file=sys.stderr)

    def close(self):
        """Stop run() (on whichever thread it runs), then close the
        socket it polls."""
        self._stop.set()
        runner = self._runner
        if runner is not None and runner is not threading.current_thread():
            runner.join()
        self.socket.close()


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(
        prog="salsify-receiver",
        description="Salsify real-time receiver (salsify-receiver.cc)")
    parser.add_argument("port")
    parser.add_argument("width", type=int)
    parser.add_argument("height", type=int)
    parser.add_argument("-f", "--fullscreen", action="store_true")
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument("-o", "--output", default=None,
                        help="write received frames to a y4m file "
                             "(headless display)")
    parser.add_argument("--torch-device", default="cuda",
                        help="torch device that reconstructs the frames")
    args = parser.parse_args(argv)

    on_raster = None
    writer = None
    if args.output:
        from alfalfa_tpu_torch.util.y4m import Y4MWriter

        def on_raster(raster):
            nonlocal writer
            y, u, v = raster.display()
            if writer is None:
                writer = Y4MWriter(args.output, y.shape[1], y.shape[0])
            writer.append_frame(y, u, v)
            writer.f.flush()  # survive an unclean shutdown
    else:
        try:
            from alfalfa_tpu_torch.display import VideoDisplay
            display = VideoDisplay(args.width, args.height,
                                   fullscreen=args.fullscreen)
            on_raster = display.draw
        except Exception as e:
            print(f"display unavailable ({e}); frames decoded but dropped",
                  file=sys.stderr)

    receiver = SalsifyReceiver(args.port, args.width, args.height,
                               verbose=args.verbose, on_raster=on_raster,
                               device=args.torch_device)
    try:
        return receiver.run()
    finally:
        if writer is not None:
            writer.close()
        receiver.close()


if __name__ == "__main__":
    sys.exit(main())
