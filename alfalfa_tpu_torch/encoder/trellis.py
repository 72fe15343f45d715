"""Host tables of the trellis (RD-optimal) quantizer, the --two-pass
encoder's second-pass quantizer (reference encoder/encoder.cc:220-408,
based on libvpx vp8/encoder/encodemb.c).

The per-block 2-level Viterbi itself runs in ops/trellis.py (plain
PyTorch, vectorised over blocks) and csrc/trellis.cuh (inside the
keyframe-encode kernel).  What stays on the host is what both read: the
token bit costs under the frame's probability tables
(``fill_token_costs``), and the sign + extra-bits cost of each coefficient
value (``VALUE_COST``).
"""
import numpy as np

from alfalfa_tpu_torch.bitstream import tables as T
from .costs import cost_bit

# token enum (decoder/tokens.hh:36-49): ZERO..FOUR, CAT1..CAT6, EOB
ZERO_TOKEN, ONE_TOKEN = 0, 1
DCT_VAL_CATEGORY1, DCT_EOB_TOKEN = 5, 11

# VP8 coefficient token tree (RFC 6386 section 13.2); negative/zero = leaf
COEF_TREE = np.array([
    -DCT_EOB_TOKEN, 2,
    -ZERO_TOKEN, 4,
    -ONE_TOKEN, 6,
    8, 12,
    -2, 10,
    -3, -4,
    14, 16,
    -DCT_VAL_CATEGORY1, -6,
    18, 20,
    -7, -8,
    -9, -10], np.int32)


def token_for_coeff(coeff):
    """encoder/costs.cc:242-261"""
    a = abs(int(coeff))
    if a <= 4:
        return a  # ZERO..FOUR tokens share the enum value
    for cat, bound in enumerate((6, 10, 18, 34, 66)):
        if a <= bound:
            return DCT_VAL_CATEGORY1 + cat
    return DCT_VAL_CATEGORY1 + 5


def _build_value_cost():
    """Sign + category-extra-bits cost per coefficient value, the
    dct_value_cost table of encoder/costs.cc:613-645 computed from the
    category bit probabilities instead of hardcoded."""
    out = np.zeros(4096, np.uint32)
    for v in range(-2048, 2048):
        a = abs(v)
        if a == 0:
            continue
        cost = cost_bit(128, v < 0)  # sign bit (asymmetric around 1/2)
        tok = token_for_coeff(a)
        if tok == DCT_VAL_CATEGORY1:
            # single extra bit at the fixed prob 159 (serializer.cc:659)
            cost += cost_bit(159, a - 5)
        elif tok > DCT_VAL_CATEGORY1:
            base, probs = T.TOKEN_DECODERS[tok - DCT_VAL_CATEGORY1 - 1]
            extra = a - base
            n = len(probs)
            for i, p in enumerate(probs):
                bit = (extra >> (n - 1 - i)) & 1
                cost += cost_bit(int(p), bit)
        out[2048 + v] = cost
    return out


# VALUE_COST[2048 + v]: the cost of coefficient value v in -2048..2047
VALUE_COST = _build_value_cost()


def coeff_base_cost(coeff):
    return int(VALUE_COST[2048 + int(coeff)])


def _tree_costs(probs, start, out):
    """Walk COEF_TREE from node pair `start`, accumulating per-leaf bit
    costs into `out` (compute_cost, encoder/costs.cc:151-170)."""
    stack = [(start, 0)]
    while stack:
        idx, cost = stack.pop()
        prob = int(probs[idx >> 1])
        for b in (0, 1):
            entry = int(COEF_TREE[idx + b])
            c = cost + cost_bit(prob, b)
            if entry <= 0:
                out[-entry] = c
            else:
                stack.append((entry, c))


def fill_token_costs(coeff_probs):
    """(4, 8, 3, 11) probs -> (4, 8, 3, 12) uint32 per-token bit costs
    (encoder/costs.cc:172-189).  Contexts where EOB cannot occur (after a
    zero, except the first band) skip the EOB branch."""
    out = np.zeros((4, 8, 3, 12), np.uint32)
    for i in range(4):
        for j in range(8):
            for k in range(3):
                start = 2 if (k == 0 and j > (1 if i == 0 else 0)) else 0
                _tree_costs(coeff_probs[i][j][k], start, out[i, j, k])
    return out


def token_costs_pm(coeff_probs):
    """(4, 16, 36) int32 position-major token costs: [bt, idx] =
    fill_token_costs(coeff_probs)[bt, COEFF_TO_BAND[idx]], flattened
    ctx-major (entry = ctx * 12 + token).  The layout the JAX package's
    TPU trellis reads (its ops/trellis_pallas.py:token_costs_pm)."""
    tc = fill_token_costs(coeff_probs)
    band = np.asarray(T.COEFF_TO_BAND, np.int64)
    return np.ascontiguousarray(
        tc[:, band].reshape(4, 16, 36).astype(np.int32))
