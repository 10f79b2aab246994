"""loop_latency_p95_ms (ms): the 95th percentile, over every loop edge due
in the window, of the time from its due time to the return of the trigger
that wrote back a trajectory including it (records.edge_latencies_ms)."""

from port_bench.harness import records


def read(rec):
    return records.percentile(records.edge_latencies_ms(rec), 95)
