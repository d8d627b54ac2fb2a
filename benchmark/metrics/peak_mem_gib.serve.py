"""The window's peak of allocated device memory, in GiB
(`torch.cuda.max_memory_allocated` after a reset at the window's start)."""


def read(record):
    return record["peak_bytes"] / 2**30 if record["peak_bytes"] else None
