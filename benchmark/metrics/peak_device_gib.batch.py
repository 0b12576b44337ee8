"""peak_device_gib.batch: torch.cuda.max_memory_allocated over the window,
reset at its start, in GiB (2^30 bytes). A smaller footprint admits a
larger batch."""


def read(run):
    if run.peak_bytes <= 0:
        return None
    return run.peak_bytes / 2 ** 30
