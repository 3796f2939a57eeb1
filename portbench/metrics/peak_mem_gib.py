"""Peak device memory of the run: ``torch.cuda.max_memory_allocated()``
over set-up and window (after ``reset_peak_memory_stats()`` on each of the
cell's cards at the start), read when the window ends, before any
correctness work, on the fullest card. The allocator's own high-water
mark, read by the benchmark."""

UNIT, BETTER, SOURCE = "GiB", "lower", "device_trace"


def read(record):
    return record.peak_bytes / 2**30
