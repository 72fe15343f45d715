"""Salsify: low-latency real-time video over lossy networks.

The sender encodes each camera frame speculatively at two quality levels
from a *state-addressed* encoder (every encoder state is a minihash the
receiver can acknowledge), picks the output that fits the instantaneous
network capacity, or skips the frame.  The receiver reassembles fragments,
decodes with error concealment when packets are lost, and ACKs every packet
with its delay EWMA and held states.  (reference src/salsify/.)
"""
from .sender import SalsifySender
from .receiver import SalsifyReceiver

__all__ = ["SalsifySender", "SalsifyReceiver"]
