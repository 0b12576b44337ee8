"""The matcher's layer (ops/sgbm_cuda.py): its kernels' names and the work
the algorithm needs, counted from its shapes, whatever kernels implement it.

Operations per voxel (one pixel at one disparity, H x W x D a frame):

    BT cost     c_lr = max(0, l - rmax, rmin - l): 2 sub + 2 max;
                c_rl the same; min of the two; x 2         10
    box sum     running sums along y and x: add + sub each   4
    each path   min(L(d-1), L(d+1)), + P1, min with L(d),
                min with minL + P2, + C, - minL: 6;
                running min of the new L over d: 1;
                S += L: 1                                     8 x paths
    WTA         argmin compare, uniqueness compare and
                the |d - d*| > 1 test                         3
    total at 8 paths                                         81

Operations per pixel: Sobel x-derivative and clip of both images (9 each),
BT half-sample min and max of both (8 each), subpixel parabola and 1/16
rounding (10), LR scatter and check (6), speckle links, labels and keep
(10): 60. The box sum is counted as running sums, so the block size does
not enter.

Bytes: each input read once (left and right float32 images) and the
output written once (the float32 disparity): 12 a pixel.

A frame here is one matcher frame: with the right matcher every pair is
two (the left view and the mirrored right view)."""

import re

KERNELS = re.compile(
    r"\b(cost_box_kernel|cost_pair_strip_kernel|cost_down_kernel"
    r"|sgm_pass_kernel|sgm_pass_i16_kernel|tile_sweep_kernel"
    r"|tile_horiz_kernel|tile_lr_kernel|wta_lr_kernel|wta_lr3_kernel"
    r"|labels_tiles|labels_borders|labels_resolve|keep_count|keep_add"
    r"|keep_apply|sweep_init|sweep_rows|sweep_cols|radix_\w+|runs_\w+)\b")

OPS_PER_VOXEL_FIXED = 10 + 4 + 3   # BT cost, box sum, WTA
OPS_PER_VOXEL_PATH = 8
OPS_PER_PIXEL = 60
BYTES_PER_PIXEL = 12


def ops(frames: int, H: int, W: int, D: int, paths: int, block: int) -> int:
    del block   # running sums: the window's size does not change the work
    voxels = frames * H * W * D
    return (voxels * (OPS_PER_VOXEL_FIXED + OPS_PER_VOXEL_PATH * paths)
            + frames * H * W * OPS_PER_PIXEL)


def nbytes(frames: int, H: int, W: int) -> int:
    return frames * H * W * BYTES_PER_PIXEL
