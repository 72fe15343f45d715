"""Carrying codec state between the JAX package and this one.

The system has no weights; what persists from frame to frame is the codec
state: per-GOP header state (probability tables, segmentation, filter
adjustments) and the three reference rasters, or a whole single-frame
``Decoder``.  These functions move them through plain numpy, so a stream
can be decoded part-way by one package and continued by the other.
Neither package is imported by the other: the ``*_to_dict`` functions read
attributes only and accept either package's objects; the ``*_from_dict``
functions build this package's objects unless they are handed the other
package's classes.
"""
import numpy as np
import torch

from alfalfa_tpu_torch.state import decoder_state as _DS

PLANES = ("y", "u", "v")


def refs_from_numpy(last, golden, alt, device=None):
    """One plane's references, three (G, H, W) uint8 numpy arrays
    (macroblock-padded), as the decoder's (G, 3, H, W) uint8 tensor."""
    device = torch.device("cuda" if device is None else device)
    stack = np.stack([np.asarray(last, np.uint8), np.asarray(golden, np.uint8),
                      np.asarray(alt, np.uint8)], axis=1)
    return torch.from_numpy(np.ascontiguousarray(stack)).to(device)


def refs_to_numpy(refs):
    """Inverse of refs_from_numpy: (last, golden, alt) numpy arrays."""
    a = refs.cpu().numpy()
    return a[:, 0], a[:, 1], a[:, 2]


def decoder_state_to_dict(state):
    """The fields of a DecoderState as plain numpy / Python values."""
    pt = state.probability_tables
    seg, fa = state.segmentation, state.filter_adjustments
    return {
        "width": int(state.width), "height": int(state.height),
        "probability_tables": {
            k: np.array(getattr(pt, k))
            for k in ("coeff_probs", "y_mode_probs", "uv_mode_probs",
                      "mv_probs")},
        "segmentation": None if seg is None else {
            "absolute": bool(seg.absolute),
            "quantizer_adjustments": np.array(seg.quantizer_adjustments),
            "filter_adjustments": np.array(seg.filter_adjustments),
            "map": np.array(seg.map)},
        "filter_adjustments": None if fa is None else {
            "ref_adjustments": np.array(fa.ref_adjustments),
            "mode_adjustments": np.array(fa.mode_adjustments)},
    }


def decoder_state_from_dict(d, classes=_DS):
    """A DecoderState from decoder_state_to_dict's output.  ``classes`` is
    the module that provides DecoderState, ProbabilityTables, Segmentation
    and FilterAdjustments: this package's by default."""
    pt = classes.ProbabilityTables(
        **{k: np.array(v) for k, v in d["probability_tables"].items()})
    seg = d["segmentation"]
    if seg is not None:
        seg = classes.Segmentation(
            bool(seg["absolute"]), np.array(seg["quantizer_adjustments"]),
            np.array(seg["filter_adjustments"]), np.array(seg["map"]))
    fa = d["filter_adjustments"]
    if fa is not None:
        fa = classes.FilterAdjustments(np.array(fa["ref_adjustments"]),
                                       np.array(fa["mode_adjustments"]))
    return classes.DecoderState(d["width"], d["height"], pt, seg, fa)


def _host(plane):
    """A plane of either package's Raster as numpy."""
    if isinstance(plane, torch.Tensor):
        return plane.cpu().numpy()
    return np.asarray(plane)


def raster_to_dict(raster):
    """Either package's Raster as {display_width, display_height, y, u, v}
    with numpy planes."""
    return {"display_width": int(raster.display_width),
            "display_height": int(raster.display_height),
            **{p: _host(getattr(raster, p)) for p in PLANES}}


def raster_from_dict(d, classes=None, device=None):
    """A Raster from raster_to_dict's output: this package's, with planes
    on ``device`` (default CUDA), or, given the other package's
    decoder_state module as ``classes``, that package's with numpy
    planes."""
    planes = [np.array(d[p], np.uint8) for p in PLANES]
    if classes is not None:
        return classes.Raster(d["display_width"], d["display_height"], *planes)
    dev = torch.device("cuda" if device is None else device)
    return _DS.Raster(d["display_width"], d["display_height"],
                      *(torch.from_numpy(p).to(dev) for p in planes))


_REFS = ("last", "golden", "alternative")


def references_to_dict(refs):
    """Either package's References as {"rasters": [...], "last": i,
    "golden": j, "alternative": k}: each distinct raster once, and which
    one each slot holds, so rasters shared between slots stay shared."""
    rasters, index = [], {}
    for name in _REFS:
        r = getattr(refs, name)
        if id(r) not in index:
            index[id(r)] = len(rasters)
            rasters.append(raster_to_dict(r))
    return {"rasters": rasters,
            **{name: index[id(getattr(refs, name))] for name in _REFS}}


def references_from_dict(d, classes=None, device=None):
    """References from references_to_dict's output (see raster_from_dict
    for ``classes`` and ``device``)."""
    rasters = [raster_from_dict(r, classes, device) for r in d["rasters"]]
    cls = _DS.References if classes is None else classes.References
    return cls(*(rasters[d[name]] for name in _REFS))


def decoder_to_dict(decoder):
    """Either package's single-frame Decoder as plain values."""
    return {"state": decoder_state_to_dict(decoder.state),
            "references": references_to_dict(decoder.references),
            "error_concealment": bool(decoder.error_concealment)}


def decoder_from_dict(d, decoder_cls=None, classes=None, device=None):
    """A Decoder from decoder_to_dict's output: this package's on
    ``device`` (default CUDA), or, given the other package's Decoder class
    and decoder_state module, that package's (with its default backend)."""
    state = decoder_state_from_dict(d["state"],
                                    _DS if classes is None else classes)
    refs = references_from_dict(d["references"], classes, device)
    kw = dict(state=state, references=refs,
              error_concealment=d["error_concealment"])
    if decoder_cls is not None:
        return decoder_cls(state.width, state.height, **kw)
    from alfalfa_tpu_torch.decoder import Decoder
    return Decoder(state.width, state.height, device=device, **kw)
