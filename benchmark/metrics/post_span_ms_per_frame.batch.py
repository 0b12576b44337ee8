"""post_span_ms_per_frame.batch: device ms a frame of the operations
launched inside the program's ``sdr.post`` span: reprojection, the output
dict and the frame stats (ops/reproject.py, metrics.py). Unlike
post_ms_per_frame.batch, which goes by kernel order, it leaves out the WLS
filter's ratio (the WLS layer's)."""

from harness import spans


def read(run):
    return spans.device_ms_per_frame(run, "sdr.post")
