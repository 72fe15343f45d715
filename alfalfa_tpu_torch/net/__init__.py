"""Network layer: Salsify's UDP transport primitives.

Wire-compatible with the reference's packet formats (net/packet.hh:41-189)
so our sender/receiver interoperate with alfalfa's at the datagram level.
"""
from .packet import Packet, FragmentedFrame, AckPacket
from .pacer import Pacer
from .poller import Poller, Action, Direction, Result, ResultType
from .socket import UDPSocket

__all__ = ["Packet", "FragmentedFrame", "AckPacket", "Pacer", "Poller",
           "Action", "Direction", "Result", "ResultType", "UDPSocket"]
