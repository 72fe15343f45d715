"""The coefficient token parse (RFC 6386 section 13) in pure Python, with
the boolean decoder written out inline.

The same walk as ``FrameParser._parse_tokens`` (the contexts, the Y2
relinking over skipped macroblocks, the token tree, the extra bits), but
each boolean read is expanded in place from the ``GET(target, prob)``
template below, so that the bit-serial loop runs without a method call a
bit.  The decoder keeps a window of ``B`` bits in ``value``; a read
compares against ``split << (B - 8)`` (the RFC's 16-bit comparison with
the low bits carried along), normalises by shrinking ``B`` and refills a
few bytes at a time, zeros past the end as the RFC's decoder reads them.
"""
import array
import re

import numpy as np

from . import tables as T

_NORM = [0] * 256
for _r in range(1, 256):
    _s, _v = 0, _r
    while _v < 128:
        _v <<= 1
        _s += 1
    _NORM[_r] = _s

_GET = """\
{ind}_sp = 1 + (((rng - 1) * ({prob})) >> 8)
{ind}_bs = _sp << (B - 8)
{ind}if value >= _bs:
{ind}    value -= _bs
{ind}    rng -= _sp
{ind}    {target} = 1
{ind}else:
{ind}    rng = _sp
{ind}    {target} = 0
{ind}_sh = NORM[rng]
{ind}rng <<= _sh
{ind}B -= _sh
{ind}if B < 24:
{ind}    value = (value << 32) | int.from_bytes(data[pos:pos + 4], "big") << (8 * max(0, 4 - len(data[pos:pos + 4])))
{ind}    pos += 4
{ind}    B += 32
"""

_BLOCK = """\
def _block(st, out, base, probs_bt, ctx, first):
    data, pos, value, B, rng = st
    nonzero = 0
    last_zero = 0
    index = first
    while index < 16:
        prob = probs_bt[BAND[index]][ctx]
        if not last_zero:
            GET(b, prob[0])
            if not b:
                break
        GET(b, prob[1])
        if not b:
            last_zero = 1
            ctx = 0
            index += 1
            continue
        last_zero = 0
        nonzero = 1
        GET(b, prob[2])
        if not b:
            v = 1
            ctx = 1
        else:
            ctx = 2
            GET(b, prob[3])
            if not b:
                GET(b, prob[4])
                if not b:
                    v = 2
                else:
                    GET(b, prob[5])
                    v = 4 if b else 3
            else:
                GET(b, prob[6])
                if not b:
                    GET(b, prob[7])
                    if not b:
                        GET(b, 159)
                        v = 5 + b
                    else:
                        k = 0
                        v = 0
                        for p in EXTRA[0][1]:
                            GET(b, p)
                            v = (v << 1) + b
                        v += EXTRA[0][0]
                else:
                    GET(b, prob[8])
                    if not b:
                        GET(b, prob[9])
                        k = 2 if b else 1
                    else:
                        GET(b, prob[10])
                        k = 4 if b else 3
                    v = 0
                    for p in EXTRA[k][1]:
                        GET(b, p)
                        v = (v << 1) + b
                    v += EXTRA[k][0]
        GET(b, 128)
        out[base + ZIGZAG[index]] = -v if b else v
        index += 1
    st[1], st[2], st[3], st[4] = pos, value, B, rng
    return nonzero
"""


def _expand(src):
    lines = []
    for line in src.splitlines():
        m = re.match(r"^(\s*)GET\((\w+), (.+)\)$", line)
        if m:
            lines.append(_GET.format(ind=m.group(1), target=m.group(2),
                                     prob=m.group(3)).rstrip("\n"))
        else:
            lines.append(line)
    return "\n".join(lines) + "\n"


_ns = {"NORM": _NORM, "BAND": [int(x) for x in T.COEFF_TO_BAND],
       "ZIGZAG": [int(x) for x in T.ZIGZAG],
       "EXTRA": [(int(b), [int(p) for p in ps]) for b, ps in T.TOKEN_DECODERS]}
exec(compile(_expand(_BLOCK), "<vp8 tokens>", "exec"), _ns)
_block = _ns["_block"]


def _start(data):
    """A decoder over ``data``: [data, pos, value, B, range]."""
    head = data[:4] + bytes(max(0, 4 - len(data)))
    return [data, 4, int.from_bytes(head, "big"), 32, 255]


def parse_tokens(parts, R, C, coeff_probs, skip_coeff, y2_coded):
    """Coefficients (R, C, 25, 16) int16 in raster order and the
    has-nonzero flags (R, C) of one frame's token partitions."""
    probs = coeff_probs.tolist()
    out = array.array("h", bytes(2 * R * C * 400))
    nzmb = bytearray(R * C)
    st = [_start(bytes(p)) for p in parts]
    y_nz = [[0] * (C * 4) for _ in range(R * 4)]
    u_nz = [[0] * (C * 2) for _ in range(R * 2)]
    v_nz = [[0] * (C * 2) for _ in range(R * 2)]
    y2_above = [0] * C
    skip = skip_coeff.tolist()
    y2c = y2_coded.tolist()
    p_y2, p_uv = probs[T.BLOCK_Y2], probs[T.BLOCK_UV]
    p_after, p_without = probs[T.BLOCK_Y_AFTER_Y2], probs[T.BLOCK_Y_WITHOUT_Y2]
    for r in range(R):
        s = st[r % len(st)]
        y2_left = 0
        for c in range(C):
            if skip[r][c]:
                for k in range(4):
                    y_nz[r * 4 + k][c * 4:c * 4 + 4] = [0, 0, 0, 0]
                for k in range(2):
                    u_nz[r * 2 + k][c * 2:c * 2 + 2] = [0, 0]
                    v_nz[r * 2 + k][c * 2:c * 2 + 2] = [0, 0]
                if y2c[r][c]:
                    y2_above[c] = 0
                    y2_left = 0
                continue
            base = (r * C + c) * 400
            nz_any = 0
            if y2c[r][c]:
                nz = _block(s, out, base + 24 * 16, p_y2,
                            y2_above[c] + y2_left, 0)
                y2_above[c] = y2_left = nz
                nz_any |= nz
                pb, first = p_after, 1
            else:
                pb, first = p_without, 0
            for sr in range(4):
                above = y_nz[r * 4 + sr - 1] if r * 4 + sr > 0 else None
                row = y_nz[r * 4 + sr]
                for sc in range(4):
                    gc = c * 4 + sc
                    ctx = (above[gc] if above is not None else 0) + \
                        (row[gc - 1] if gc > 0 else 0)
                    nz = _block(s, out, base + (sr * 4 + sc) * 16, pb, ctx, first)
                    row[gc] = nz
                    nz_any |= nz
            for plane, b0 in ((u_nz, 16), (v_nz, 20)):
                for sr in range(2):
                    above = plane[r * 2 + sr - 1] if r * 2 + sr > 0 else None
                    row = plane[r * 2 + sr]
                    for sc in range(2):
                        gc = c * 2 + sc
                        ctx = (above[gc] if above is not None else 0) + \
                            (row[gc - 1] if gc > 0 else 0)
                        nz = _block(s, out, base + (b0 + sr * 2 + sc) * 16,
                                    p_uv, ctx, 0)
                        row[gc] = nz
                        nz_any |= nz
            nzmb[r * C + c] = nz_any
    coeffs = np.frombuffer(out, np.int16).reshape(R, C, 25, 16).copy()
    has_nonzero = np.frombuffer(bytes(nzmb), np.uint8).reshape(R, C).astype(bool)
    return coeffs, has_nonzero
