from .encoder import Encoder

__all__ = ["Encoder"]
