"""The test corpus through the port's two decoders, distinct streams side
by side.

ExCamera's batch decode runs G different chunks in lockstep.  This module
groups the clips of ``tests/fixtures/natural_manifest.json`` (and any
extra fixtures of ``tests/fixtures/manifest.json``) by width, height and
each frame position's (key frame, shown) pattern, the condition
``BatchedGopDecoder`` puts on its GOPs, and decodes each group as one
batch, every GOP a different clip.  Each GOP's raster SHA-1 (the shown
frames' ``Raster.dump_bytes()``, cropped to the display size) must equal
its clip's ``yuv_sha1``.

    from alfalfa_tpu_torch.tools import corpus
    for group in corpus.groups():
        got = corpus.decode_batch(group, device="cpu")
        assert got == [c.yuv_sha1 for c in group.clips]

``natural/pan_82x48_q40.ivf`` holds no frame and has no manifest entry,
so it is in no group.
"""
import collections
import hashlib
import json
import os

import torch

from alfalfa_tpu_torch.decoder import FilePlayer
from alfalfa_tpu_torch.parallel.gop import BatchedGopDecoder
from alfalfa_tpu_torch.state.decoder_state import Raster
from alfalfa_tpu_torch.util.ivf import IVFReader

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "fixtures")
NATURAL_MANIFEST = os.path.join(FIXTURES, "natural_manifest.json")
MANIFEST = os.path.join(FIXTURES, "manifest.json")

Clip = collections.namedtuple("Clip", "name path payloads yuv_sha1")
Group = collections.namedtuple("Group", "width height pattern clips")


def frame_pattern(payloads):
    """Each frame's (key frame, shown) flags, from its frame tag."""
    return tuple(((p[0] & 1) == 0, bool(p[0] >> 4 & 1)) for p in payloads)


def alone(path, yuv_sha1=None):
    """The IVF file at ``path`` as a group of one clip."""
    ivf = IVFReader(path)
    payloads = [ivf.frame(i) for i in range(len(ivf))]
    return Group(ivf.width, ivf.height, frame_pattern(payloads),
                 [Clip(os.path.basename(path), path, payloads, yuv_sha1)])


def groups(extra=()):
    """The natural corpus, and the fixtures named in ``extra`` (names in
    ``tests/fixtures/manifest.json``), as [Group] in a fixed order: the
    larger batches first, clips by name within one."""
    with open(NATURAL_MANIFEST) as fh:
        entries = [(os.path.join(FIXTURES, "natural", n), e["yuv_sha1"])
                   for n, e in sorted(json.load(fh).items())]
    with open(MANIFEST) as fh:
        fixtures = json.load(fh)
    entries += [(os.path.join(FIXTURES, n), fixtures[n]["yuv_sha1"])
                for n in extra]
    by_key = collections.OrderedDict()
    for path, sha in entries:
        one = alone(path, sha)
        by_key.setdefault(one[:3], []).extend(one.clips)
    out = [Group(w, h, pat, clips) for (w, h, pat), clips in by_key.items()]
    return sorted(out, key=lambda g: (-len(g.clips), g.width * g.height))


def decode_batch(group, device, token_engine="scalar", frames=None,
                 per_frame=False):
    """One ``BatchedGopDecoder(G=len(group.clips))`` over the group, each
    GOP a different clip (their first ``frames`` frames, or all).  Returns
    each GOP's SHA-1 over its shown frames, or with ``per_frame`` the
    list of each shown frame's SHA-1."""
    G = len(group.clips)
    n = len(group.pattern) if frames is None else frames
    dec = BatchedGopDecoder(group.width, group.height, G, device=device,
                            token_engine=token_engine)
    digests = [[] if per_frame else hashlib.sha1() for _ in range(G)]
    for (y, u, v), show in dec.decode_stream(
            [c.payloads[f] for c in group.clips] for f in range(n)):
        ya, ua, va = (p.cpu().numpy() for p in (y, u, v))
        for g in range(G):
            if show[g]:
                raw = Raster(group.width, group.height, ya[g], ua[g],
                             va[g]).dump_bytes()
                if per_frame:
                    digests[g].append(hashlib.sha1(raw).hexdigest())
                else:
                    digests[g].update(raw)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return digests if per_frame else [d.hexdigest() for d in digests]


def play(path, device, per_frame=False):
    """``FilePlayer(path, device)``: the SHA-1 over the shown frames, or
    with ``per_frame`` each shown frame's."""
    shas, whole = [], hashlib.sha1()
    for raster in FilePlayer(path, device=device):
        raw = raster.dump_bytes()
        whole.update(raw)
        shas.append(hashlib.sha1(raw).hexdigest())
    return shas if per_frame else whole.hexdigest()
