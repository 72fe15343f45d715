"""Bit-cost tables for RD decisions (reference encoder/costs.cc).

Costs are in the reference's 1/256-bit fixed-point units; a tree leaf's cost
is the sum of per-branch bit costs along its path.
"""
import numpy as np

from alfalfa_tpu_torch.bitstream import tables as T
from alfalfa_tpu_torch.bitstream.boolcoder import tree_path

PROB_COST = T.VP8_PROB_COST.astype(np.uint32)


def cost_bit(prob, bit):
    return int(PROB_COST[255 - prob if bit else prob])


def tree_leaf_costs(tree_arr, probs):
    """Cost of each leaf of a coding tree under the given probabilities."""
    leaves = sorted({-int(v) for v in tree_arr if v <= 0})
    out = np.zeros(max(leaves) + 1, np.uint32)
    for leaf in leaves:
        bits = tree_path(tree_arr, leaf)
        cost = 0
        i = 0
        for b in bits:
            cost += cost_bit(int(probs[i >> 1]), b)
            i = int(tree_arr[i + b])
        out[leaf] = cost
    return out


class Costs:
    """Static mode-cost tables (fill_mode_costs, costs.cc:191-208)."""

    def __init__(self):
        # [0] = keyframe trees/probs, [1] = interframe
        self.mbmode_costs = [
            tree_leaf_costs(T.KF_Y_MODE_TREE, T.KF_Y_MODE_PROBS),
            tree_leaf_costs(T.Y_MODE_TREE, T.DEFAULT_Y_MODE_PROBS)]
        self.intra_uv_mode_costs = [
            tree_leaf_costs(T.UV_MODE_TREE, T.KF_UV_MODE_PROBS),
            tree_leaf_costs(T.UV_MODE_TREE, T.DEFAULT_UV_MODE_PROBS)]
        # bmode_costs[above][left][mode] (keyframe contextual probs)
        self.bmode_costs = np.zeros((10, 10, 10), np.uint32)
        for i in range(10):
            for j in range(10):
                self.bmode_costs[i, j] = tree_leaf_costs(
                    T.B_MODE_TREE, T.KF_B_MODE_PROBS[i][j])
        self.inter_bmode_costs = tree_leaf_costs(T.B_MODE_TREE,
                                                 T.INVARIANT_B_MODE_PROBS)

    def mv_component_cost(self, num, probs):
        """costs.cc:77-110"""
        x = abs(int(num) >> 1)
        if x < 8:
            cost = cost_bit(probs[0], 0)
            # 3-bit tree walk for small mv
            i = 0
            for n in (2, 1, 0):
                b = (x >> n) & 1
                cost += cost_bit(int(probs[2 + (i >> 1)]), b)
                i = int(T.SMALL_MV_TREE[i + b])
            if x == 0:
                return cost
        else:
            cost = cost_bit(probs[0], 1)
            for i in range(3):
                cost += cost_bit(int(probs[9 + i]), (x >> i) & 1)
            for i in range(9, 3, -1):
                cost += cost_bit(int(probs[9 + i]), (x >> i) & 1)
            if x & 0xFFF0:
                cost += cost_bit(int(probs[9 + 3]), (x >> 3) & 1)
        return cost + cost_bit(int(probs[1]), 0)  # sign bit (either way ~1 bit)

    def mv_cost(self, mv, mv_probs):
        return (self.mv_component_cost(mv[1], mv_probs[0])
                + self.mv_component_cost(mv[0], mv_probs[1]))


def rdcost(rate, distortion, rate_multiplier, distortion_multiplier):
    """encoder.cc:410-416"""
    return ((128 + rate * rate_multiplier) // 256
            + distortion * distortion_multiplier)


def rd_multipliers(y_ac_quantizer):
    """libvpx-style lambda from the quantizer (encoder.cc:178-193)."""
    q_ac = min(int(y_ac_quantizer), 160)
    rate_multiplier = int(q_ac * q_ac * 2.80)
    if rate_multiplier > 1000:
        return rate_multiplier // 100, 1
    return rate_multiplier, 100
