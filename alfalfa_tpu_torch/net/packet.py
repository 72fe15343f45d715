"""Salsify packet formats: data fragments and ACKs.

Wire format matches the reference exactly (little-endian fields in the order
of net/packet.cc:90-109, 124-136, 329-357):

  data packet header (22 bytes):
    u16 connection_id | u32 source_state | u32 target_state | u32 frame_no |
    u16 fragment_no | u16 fragments_in_this_frame | u32 time_since_last (us)
  followed by up to 1400 payload bytes.

  ack packet:
    u16 connection_id | u32 frame_no | u16 fragment_no | u32 avg_delay (us) |
    u32 current_state | u32 n | n * u32 complete_states

``source_state``/``target_state``/``current_state`` are decoder minihashes —
the state-addressed encoding that lets the sender pick any encoder whose
source state the receiver is known to hold (net/packet.hh:41-95).
"""
import struct

MAXIMUM_PAYLOAD = 1400  # net/packet.hh:57

_HDR = struct.Struct("<HIIIHHI")   # 22 bytes
_ACK_HDR = struct.Struct("<HIHII")  # 16 bytes + u32 count + states


class Packet:
    """One UDP datagram carrying a fragment of a compressed frame."""

    __slots__ = ("valid", "connection_id", "source_state", "target_state",
                 "frame_no", "fragment_no", "fragments_in_this_frame",
                 "time_since_last", "payload")

    def __init__(self, connection_id=0, source_state=0, target_state=0,
                 frame_no=0, fragment_no=0, fragments_in_this_frame=0,
                 time_since_last=0, payload=b"", valid=True):
        self.valid = valid
        self.connection_id = connection_id
        self.source_state = source_state
        self.target_state = target_state
        self.frame_no = frame_no
        self.fragment_no = fragment_no
        self.fragments_in_this_frame = fragments_in_this_frame
        self.time_since_last = time_since_last
        self.payload = payload

    @classmethod
    def invalid(cls):
        return cls(valid=False)

    @classmethod
    def parse(cls, data):
        """Incoming-packet constructor (packet.cc:90-109)."""
        if len(data) < _HDR.size:
            raise ValueError("packet too short")
        (connection_id, source_state, target_state, frame_no,
         fragment_no, fragments_in_this_frame,
         time_since_last) = _HDR.unpack_from(data, 0)
        payload = bytes(data[_HDR.size:])
        if fragment_no >= fragments_in_this_frame:
            raise ValueError("invalid packet: fragment_no >= fragments_in_this_frame")
        if not payload:
            raise ValueError("invalid packet: empty payload")
        return cls(connection_id, source_state, target_state, frame_no,
                   fragment_no, fragments_in_this_frame, time_since_last,
                   payload)

    def to_bytes(self):
        assert self.fragments_in_this_frame > 0
        return _HDR.pack(self.connection_id, self.source_state,
                         self.target_state, self.frame_no, self.fragment_no,
                         self.fragments_in_this_frame,
                         self.time_since_last) + self.payload


class FragmentedFrame:
    """A compressed frame split into <=1400-byte fragments, or reassembled
    from incoming fragments (net/packet.cc:144-...)."""

    def __init__(self, connection_id, source_state=None, target_state=None,
                 frame_no=None, time_since_last=None, whole_frame=None,
                 packet=None):
        self.connection_id = connection_id
        if packet is not None:
            # incoming: size the fragment list from the first packet seen
            self.source_state = packet.source_state
            self.target_state = packet.target_state
            self.frame_no = packet.frame_no
            self.fragments_in_this_frame = packet.fragments_in_this_frame
            self.fragments = [None] * packet.fragments_in_this_frame
            self.remaining_fragments = packet.fragments_in_this_frame
            self.add_packet(packet)
            return
        # outgoing: slice whole_frame into MAXIMUM_PAYLOAD chunks
        assert whole_frame is not None and len(whole_frame) > 0
        self.source_state = source_state
        self.target_state = target_state
        self.frame_no = frame_no
        buf = bytes(whole_frame)
        n = (len(buf) + MAXIMUM_PAYLOAD - 1) // MAXIMUM_PAYLOAD
        self.fragments_in_this_frame = n
        self.fragments = [
            Packet(connection_id, source_state, target_state, frame_no,
                   i, n,
                   # only the first fragment carries the inter-frame gap
                   time_since_last if i == 0 else 0,
                   buf[i * MAXIMUM_PAYLOAD:(i + 1) * MAXIMUM_PAYLOAD])
            for i in range(n)]
        self.remaining_fragments = 0

    def sanity_check(self, packet):
        """packet.cc:193-218"""
        if packet.connection_id != self.connection_id:
            raise ValueError("invalid packet, connection_id mismatch")
        if packet.source_state != self.source_state:
            raise ValueError("invalid packet, source_state mismatch")
        if packet.target_state != self.target_state:
            raise ValueError("invalid packet, target_state mismatch")
        if packet.fragments_in_this_frame != self.fragments_in_this_frame:
            raise ValueError("invalid packet, fragments_in_this_frame mismatch")
        if packet.frame_no != self.frame_no:
            raise ValueError("invalid packet, frame_no mismatch")
        if packet.fragment_no >= self.fragments_in_this_frame:
            raise ValueError("invalid packet, fragment_no out of range")

    def add_packet(self, packet):
        self.sanity_check(packet)
        if self.fragments[packet.fragment_no] is None:
            self.remaining_fragments -= 1
            self.fragments[packet.fragment_no] = packet

    def complete(self):
        return self.remaining_fragments == 0

    def packets(self):
        if not self.complete():
            raise RuntimeError("attempt to access unfinished FragmentedFrame")
        return self.fragments

    def frame(self):
        if not self.complete():
            raise RuntimeError("attempt to build frame from unfinished FragmentedFrame")
        return b"".join(p.payload for p in self.fragments)

    def partial_frame(self):
        """Concatenate the valid prefix of fragments — the error-concealment
        input when the tail of a frame is lost (packet.cc:275-288)."""
        out = []
        for p in self.fragments:
            if p is None:
                break
            out.append(p.payload)
        return b"".join(out)


class AckPacket:
    """Receiver -> sender feedback (net/packet.hh:159-189): what arrived,
    the inter-packet-delay EWMA, the decoder's current state, and the list
    of complete states it is holding."""

    __slots__ = ("connection_id", "frame_no", "fragment_no", "avg_delay",
                 "current_state", "complete_states")

    def __init__(self, connection_id, frame_no, fragment_no, avg_delay,
                 current_state, complete_states):
        self.connection_id = connection_id
        self.frame_no = frame_no
        self.fragment_no = fragment_no
        self.avg_delay = avg_delay
        self.current_state = current_state
        self.complete_states = list(complete_states)

    @classmethod
    def parse(cls, data):
        (connection_id, frame_no, fragment_no, avg_delay,
         current_state) = _ACK_HDR.unpack_from(data, 0)
        (count,) = struct.unpack_from("<I", data, _ACK_HDR.size)
        states = list(struct.unpack_from(f"<{count}I", data, _ACK_HDR.size + 4))
        return cls(connection_id, frame_no, fragment_no, avg_delay,
                   current_state, states)

    def to_bytes(self):
        return (_ACK_HDR.pack(self.connection_id, self.frame_no,
                              self.fragment_no, self.avg_delay,
                              self.current_state)
                + struct.pack(f"<I{len(self.complete_states)}I",
                              len(self.complete_states),
                              *self.complete_states))
