"""setup_s (s): from the start of the process to the start of the
window: imports, the graph's generation, the store's prefix, the capture
of the cell's one bucket, the prefix's solves, the tail's delta builds and
replays, and the mix's lead-in."""


def read(rec):
    return rec["setup_s"]
