"""peak_mem_gib: torch.cuda.max_memory_allocated over the window, reset at
its start."""


def read(out, ctx):
    w = out.get("window")
    if not w:
        return None
    return w["peak_bytes"] / 2 ** 30
