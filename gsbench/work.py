"""Work counts and the card's peaks: the yardstick of every roofline share
and every ``mfu`` the benchmark reports.

Counts come from the cell's inputs through the benchmark's own reference
(``reference/``): a contributing pair is a (pixel, Gaussian) pair with
alpha >= 1/255 before the pixel's transmittance cut, counted by the
reference's render of the view. They never come from the program's
counters or its cull, so a better cull or a different kernel reads against
the same work.

Operations are floating-point operations (an add, a multiply, an exp, a
compare each count one); bytes count each input once and each output
once. The least time of a piece of work is the larger of its operations
over the peak rate and its bytes over the memory bandwidth.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit; the run reports the card's own limit beside them).
"""

from __future__ import annotations

from typing import NamedTuple

F32_FLOPS = 67e12         # float32 outside the tensor cores
TF32_FLOPS = 495e12       # TF32 tensor cores, dense
HBM_BYTES = 3.35e12       # HBM3

# Per contributing pair.
FWD_PAIR_OPS = 20         # power (9), exp, alpha and its two tests (4),
#                           weight α·T (1), colour (6: 3 multiply-adds)
BWD_PAIR_OPS_F32 = 30     # the forward again (14), T and the colour
#                           suffix (4), dL/dα (6), dα → power, opacity (3),
#                           power → x, y, a, b, c (3 beyond the forward)
BWD_PAIR_OPS_SUM = 18     # the 9 gradient sums over a tile's pixels
#                           (multiply-add each), which a kernel may take as
#                           matrix products: counted at the TF32 rate
# Per pixel: background blend (6) forward; its gradient (6) backward.
FWD_PIXEL_OPS = 6
BWD_PIXEL_OPS = 6
# Per Gaussian row: projection, covariance, conic, rects (about 190),
# degree-3 SH colour (16 basis terms, 48 multiply-adds: about 140).
PROJECT_OPS = 330
PROJECT_BWD_OPS = 660     # the reverse pass of the same arithmetic, twice
ADAM_OPS = 12             # per parameter: two moments, the step, the update
PARAMS_PER_ROW = 59       # xyz 3, SH 48, scaling 3, rotation 4, opacity 1
GROW_DIRS = 128           # dirs_prob per row in grow mode
SOFTMAX_OPS = 5           # per logit forward (max, sub, exp, sum, divide)
SOFTMAX_BWD_OPS = 5
# Per pixel, the loss: L1 (3) and SSIM's five 11×11 separable blurs of
# three channels (5 × 3 × 2 passes × 11 multiply-adds) and its map (~30),
# forward and backward.
LOSS_PIXEL_OPS = 3 * 3 + 5 * 3 * 2 * 11 * 2 + 30
LOSS_PIXEL_BWD_OPS = 2 * LOSS_PIXEL_OPS
# Bytes: a screen-space row (x, y, conic, opacity, rgb: 9 floats) in, a
# pixel's colour and final transmittance out; the backward reads the
# pixel's colour, transmittance and their gradient and writes a row's 9
# gradients.
ROW_BYTES = 9 * 4
FWD_PIXEL_BYTES = 4 * 4
BWD_PIXEL_BYTES = 8 * 4
BWD_ROW_BYTES = 9 * 4


class ViewWork(NamedTuple):
    pairs: int            # contributing (pixel, Gaussian) pairs
    rows: int             # Gaussians that contribute to some pixel
    pixels: int


def least_s(f32_ops: float, bytes_: float, tf32_ops: float = 0.0) -> float:
    """Least time: operations at their peaks, or bytes at HBM's rate."""
    return max(f32_ops / F32_FLOPS + tf32_ops / TF32_FLOPS,
               bytes_ / HBM_BYTES)


def composite_fwd_s(w: ViewWork) -> float:
    """Least time of the forward composite of one view (B1, B3f)."""
    return least_s(w.pairs * FWD_PAIR_OPS + w.pixels * FWD_PIXEL_OPS,
                   w.rows * ROW_BYTES + w.pixels * FWD_PIXEL_BYTES)


def composite_bwd_s(w: ViewWork) -> float:
    """Least time of the composite's backward of one view (B3b)."""
    return least_s(w.pairs * BWD_PAIR_OPS_F32 + w.pixels * BWD_PIXEL_OPS,
                   w.rows * (ROW_BYTES + BWD_ROW_BYTES)
                   + w.pixels * BWD_PIXEL_BYTES,
                   tf32_ops=w.pairs * BWD_PAIR_OPS_SUM)


def render_flops(w: ViewWork, n_rows: int) -> float:
    """Operations of one forward render: every row projected, the
    contributing pairs composited."""
    return (n_rows * PROJECT_OPS + w.pairs * FWD_PAIR_OPS
            + w.pixels * FWD_PIXEL_OPS)


def train_flops(w: ViewWork, n_rows: int, n_params: int,
                grow_rows: int = 0) -> float:
    """Operations of one training step: the render and its backward, the
    loss both ways, Adam over every parameter; in grow mode the
    straight-through softmax over ``grow_rows`` rows both ways."""
    return (render_flops(w, n_rows) + n_rows * PROJECT_BWD_OPS
            + w.pairs * (BWD_PAIR_OPS_F32 + BWD_PAIR_OPS_SUM)
            + w.pixels * (BWD_PIXEL_OPS + LOSS_PIXEL_OPS
                          + LOSS_PIXEL_BWD_OPS)
            + n_params * ADAM_OPS
            + grow_rows * GROW_DIRS * (SOFTMAX_OPS + SOFTMAX_BWD_OPS))
