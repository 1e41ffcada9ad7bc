"""peak_mem_gib: torch.cuda.max_memory_allocated() over set-up and the
window, in GiB, read by the benchmark from the CUDA allocator."""


def read(ctx):
    return ctx["peak_bytes"] / 2 ** 30
