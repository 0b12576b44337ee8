"""prep_span_ms_per_frame.batch: device ms a frame of the operations
launched inside the program's ``sdr.prep`` span: gray conversion,
rectification and downscale (pipeline.py, ops/remap.py). Unlike
prep_ms_per_frame.batch, which goes by kernel order, it leaves out the
pair's stacking and the Sobel prefilter (the matcher's) and the u8 to f32
cast (the upload's)."""

from harness import spans


def read(run):
    return spans.device_ms_per_frame(run, "sdr.prep")
