"""device_idle_pct (%): the share of the traced span (first to last
profiled trigger call) in which no kernel or copy ran on the card."""


def read(rec):
    prof = rec.get("profile") or {}
    if not prof.get("span_ns"):
        return None
    return 100.0 * (1.0 - prof["busy_ns"] / prof["span_ns"])
