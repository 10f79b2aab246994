"""device_mem_peak_mb (MB): torch.cuda.max_memory_allocated() over set-up
and window, read before the program's state is freed: the captured
solve's memory pools, the problem and the CUDA libraries' workspaces."""


def read(rec):
    peak = rec.get("memory_peak_bytes")
    return peak / 2 ** 20 if peak else None
