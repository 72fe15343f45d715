"""Intra predictions of one block on the host, without writing them into
the plane: what the rebase's intra macroblocks are predicted from
(encoder/reencode.py), copied from the JAX package's host intra encoder
(encoder/encode_intra_np.py:31-45)."""
from alfalfa_tpu_torch.decoder import reconstruct_np as R


def _predict_whole(plane, col, row, size, mode):
    """The size x size prediction (16: luma, 8: chroma) of whole-block
    mode ``mode`` at macroblock (row, col), the plane left as it was."""
    block = plane[row * size:(row + 1) * size, col * size:(col + 1) * size]
    saved = block.copy()
    R.intra_predict_mb(plane, col, row, size, mode)
    pred = block.copy()
    block[:] = saved
    return pred


def _predict_b(plane, col4, row4, mode):
    """The 4x4 prediction of b-mode ``mode`` at sub-block (row4, col4),
    the plane left as it was."""
    block = plane[row4 * 4:row4 * 4 + 4, col4 * 4:col4 * 4 + 4]
    saved = block.copy()
    R.intra_predict_b(plane, col4, row4, mode)
    pred = block.copy()
    block[:] = saved
    return pred
