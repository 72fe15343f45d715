"""The port's encoders.  ``Encoder`` is looked up when first asked for, so
that importing a submodule (``encoder.costs``, ``encoder.trellis``) from the
kernels' modules under ``ops/`` does not import ``encoder.encoder``, which
imports those modules back."""

__all__ = ["Encoder"]


def __getattr__(name):
    if name == "Encoder":
        from .encoder import Encoder
        return Encoder
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
