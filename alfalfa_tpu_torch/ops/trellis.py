"""Trellis (RD-optimal) quantization of 4x4 blocks in PyTorch, vectorised
over blocks: the plain version of H2, the per-block dynamic programme that
csrc/trellis.cuh runs inside the encode kernels.

Replaces the TPU helper alfalfa_tpu/ops/trellis_pallas.py
(trellis_quantize_pm and its trellis_nodes, final_costs, choose_level,
trellis_walk; traced inside the keyframe-encode kernel).  Same function as
the JAX package's host quantizer encoder/trellis.py:trellis_quantize
(reference encoder/encoder.cc:221-408): a 2-level Viterbi walks the zigzag
positions backwards, choosing between the quantized level q and q-1 per
coefficient by rate (token costs under the frame's probabilities plus the
value's sign and extra-bit cost) plus distortion (squared requantization
error), with the end of block pulled forward where a trailing zero makes
it cheaper.  All costs are int64.

Token costs come position-major, as encoder/trellis.py:token_costs_pm
lays them out: ``tc[idx, ctx * 12 + token]`` is the cost of ``token`` at
zigzag position ``idx`` under context class ``ctx``, for one block type.
"""
import numpy as np
import torch

from alfalfa_tpu_torch.bitstream import tables as T
from alfalfa_tpu_torch.encoder.trellis import VALUE_COST, token_for_coeff

EOB = 11


def _const(a, dev):
    return torch.as_tensor(np.asarray(a, np.int64), device=dev)


# token of a magnitude 0..67 (67 and up: DCT_VAL_CATEGORY6)
_TOKEN_OF = np.array([token_for_coeff(m) for m in range(68)], np.int64)


def token_of(mag):
    """Token of each coefficient magnitude in ``mag`` (an int64 tensor)."""
    return _const(_TOKEN_OF, mag.device)[mag.clamp(max=67)]


def _rdcost(rate, dist, rm, dm):
    return ((128 + rate * rm) >> 8) + dist * dm


def trellis_nodes(unq, dc_factor, ac_factor, tc, first, rm, dm):
    """The backward pass over B blocks.

    unq: (B, 16) unquantized coefficients in raster order; dc_factor /
    ac_factor / rm / dm: ints; tc: (16, 36) token costs of the block type;
    first: 0, or 1 for luma blocks whose DC went to Y2.

    Returns (rate, dist, tok, coeff, token, nxt): the node at ``first``
    per level, (B, 2) each, before the entry context's charge, and the
    per-position choices (B, 16, 2) the walk follows.

    Positions past the last nonzero coefficient need no mask: a zero
    before an end of block is pulled into it, which leaves the node at its
    initial value (rate 0, distortion 0, EOB)."""
    dev = unq.device
    B = unq.shape[0]
    tc = tc.to(torch.int64)
    u = unq.to(torch.int64)[:, _const(T.ZIGZAG, dev)]
    f = torch.full((16,), ac_factor, dtype=torch.int64, device=dev)
    f[0] = dc_factor
    # both candidate levels at every position, q and q - 1 toward zero
    # (both 0 where q is 0): (B, 16, 2)
    mag = ((u.abs() // f)[:, :, None]
           - torch.arange(2, device=dev)).clamp(min=0)
    cand = torch.where(u[:, :, None] < 0, -mag, mag)
    diff = u[:, :, None] - cand * f[:, None]
    sse = diff * diff
    tk = token_of(mag)
    vcost = _const(VALUE_COST, dev)[(2048 + cand).clamp(0, 4095)]
    cls12 = mag.clamp(max=2)[:, :, :, None] * 12     # next token's context
    zero = mag == 0
    rate = torch.zeros((B, 2), dtype=torch.int64, device=dev)
    dist = torch.zeros_like(rate)
    tok = torch.full_like(rate, EOB)
    coeffs, tokens, nxts = [], [], []
    for idx in range(15, first - 1, -1):
        # combinations: this level s (dim 1) after next level n (dim 2)
        d_sn = dist[:, None, :] + sse[:, idx, :, None]
        r_sn = rate[:, None, :]
        if idx < 15:
            r_sn = r_sn + tc[idx + 1][cls12[:, idx] + tok[:, None, :]]
        rd = _rdcost(r_sn, d_sn, rm, dm)
        bn = (rd[:, :, 1] < rd[:, :, 0]).to(torch.int64)   # ties -> level 0
        rb = r_sn.expand(B, 2, 2).gather(2, bn[:, :, None])[:, :, 0]
        db = d_sn.gather(2, bn[:, :, None])[:, :, 0]
        pull = zero[:, idx] & (tok.gather(1, bn) == EOB)   # zero before EOB
        rate = torch.where(pull, 0, rb + vcost[:, idx])
        dist = torch.where(pull, sse[:, idx], db)
        tok = torch.where(pull, EOB, tk[:, idx])
        coeffs.append(torch.where(pull, 0, cand[:, idx]))
        tokens.append(tok)
        nxts.append(torch.where(pull, 255, bn))
    pad = lambda xs, v: torch.stack(
        [torch.full_like(rate, v)] * first + xs[::-1], dim=1)
    return rate, dist, tok, pad(coeffs, 0), pad(tokens, EOB), pad(nxts, 255)


def trellis_choose(nodes, tc, first, ctx, rm, dm):
    """The start level under entry contexts ``ctx`` (B,) in 0..2: the first
    token's cost is charged, then the cheaper level wins (ties -> 0)."""
    rate, dist, tok = nodes[:3]
    row = tc[first].to(torch.int64)
    cost = _rdcost(rate + row[ctx.to(torch.int64)[:, None] * 12 + tok], dist,
                   rm, dm)
    return (cost[:, 1] < cost[:, 0]).to(torch.int64)


def trellis_walk(nodes, choice, first):
    """Follow the chosen path forward from ``first``.  Returns the (B, 16)
    int32 quantized coefficients in raster order and (B,) nonzero flags."""
    coeff, token, nxt = nodes[3:]
    dev = coeff.device
    ch = choice[:, None]
    alive = torch.ones_like(ch, dtype=torch.bool)
    emitted = []
    for idx in range(first, 16):
        alive = alive & (token[:, idx].gather(1, ch) != EOB)
        emitted.append(torch.where(alive, coeff[:, idx].gather(1, ch), 0))
        ch = torch.where(alive, nxt[:, idx].gather(1, ch), ch)
    zz_pos = torch.cat([torch.zeros_like(ch)] * first + emitted, dim=1)
    out = zz_pos[:, _const(np.argsort(T.ZIGZAG), dev)]
    return out.to(torch.int32), (out != 0).any(dim=1)


def trellis_quantize(unq, dc_factor, ac_factor, tc, ctx, first, rm, dm):
    """Trellis-quantize B blocks with known entry contexts ``ctx`` (B,).
    Returns ((B, 16) int32 raster-order coefficients, (B,) nonzero)."""
    nodes = trellis_nodes(unq, dc_factor, ac_factor, tc, first, rm, dm)
    return trellis_walk(nodes, trellis_choose(nodes, tc, first, ctx, rm, dm),
                        first)
