"""setup_s: seconds from the process's start to the window's: torch's
import and the CUDA context, rendering the input pool, the pipeline's
rectification grids, the kernels' load (and, in a checkout that has none,
their build) and the warm-up calls on the cell's own shapes."""


def read(run):
    return run.setup_s
