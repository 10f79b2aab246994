"""world_host_ms (ms): the host's world work in a trigger: over the
window's solves that returned before the profiler session
(harness/program_rows.py), the mean of the program's spans
world_mapping, first_contact, initial_guesses and priors (solve_stats
spans_ms): the node worlds, the first contacts and set unions, the
4-case initial guesses and the soft anchors. None where the rows carry
none of these spans."""

from port_bench.harness import program_rows, records

SPANS = ("world_mapping", "first_contact", "initial_guesses", "priors")


def read(rec):
    def world_ms(row):
        spans = row.get("spans_ms") or {}
        ms = [spans[k][1] for k in SPANS if k in spans]
        return sum(ms) if ms else None
    return records.mean(world_ms(r) for r in program_rows.before_profile(rec))
