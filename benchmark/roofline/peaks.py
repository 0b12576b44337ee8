"""Peaks of one NVIDIA H100 SXM at its full 700 W power limit (NVIDIA's
data sheet), the yardstick of every roofline share. Copied from the
program's utils/profiling.py so that the yardstick cannot move with it."""

HBM_BYTES_PER_S = 3.35e12    # device memory
FP32_OPS_PER_S = 67e12       # float32 outside the tensor cores


def share_pct(ops: float, nbytes: float, seconds: float):
    """100 x the least time the card could take (the larger of the ops and
    the bytes bound) over ``seconds``; None where nothing was timed."""
    if seconds <= 0:
        return None
    return 100.0 * max(ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S) / seconds
