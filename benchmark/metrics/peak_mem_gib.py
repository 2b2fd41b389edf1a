"""peak_mem_gib (GiB): torch.cuda.max_memory_allocated() over the window,
reset at its start: the resident pack, bands and chains that the
deployment holds, and what its jobs allocate."""


def read(rec):
    b = rec["peak_window_bytes"]
    return b / 2**30 if b else None
