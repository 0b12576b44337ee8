"""The WLS filter's layer (ops/wls_cuda.py): its kernels' names and the work
the algorithm needs, counted from its shapes, whatever kernels implement it.

Operations per pixel:

    LR confidence   x - round(x - dl), the bounds tests, |dr - dl| <= t,
                    dr >= 0, dl >= 0, the ands, conf * max(dl, 0)   11
    each solve      weight |g(i+1) - g(i)|, / sigma, exp: 4;
    (a row or a     a = -lam w_l, c = -lam w_r,
    column pass)    b = 1 + lam (w_l + w_r): 5;
                    r = 1 / (b - a c'), c' = c r: 4;
                    per right-hand side (2 of them):
                    d' = (d - a d') r: 3, x = d' - c' x: 2          23
    solves          2 passes (rows, columns) x iterations           x 6 at 3
    ratio           num / den where den > 1e-3                       3
    total at 3 iterations                                          152

Bytes: each input read once (the left and the right disparity and the
guide, float32) and each output written once (the filtered disparity and
the confidence, float32): 20 a pixel."""

import re

KERNELS = re.compile(r"\b(shift_gather_conf_kernel|fgs_pass_kernel)\b")

OPS_PER_PIXEL_FIXED = 11 + 3
OPS_PER_PIXEL_SOLVE = 23
BYTES_PER_PIXEL = 20


def ops(frames: int, H: int, W: int, iters: int) -> int:
    return frames * H * W * (OPS_PER_PIXEL_FIXED
                             + OPS_PER_PIXEL_SOLVE * 2 * iters)


def nbytes(frames: int, H: int, W: int) -> int:
    return frames * H * W * BYTES_PER_PIXEL
