from .decoder import Decoder, FramePlayer, FilePlayer
