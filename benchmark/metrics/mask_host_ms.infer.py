"""The host milliseconds a round inside the program span sniper/mask (the
inference mask branch's enqueue) over the traced slice, by
benchmark/core/spans.table; the profiler inflates host time. None under a
program that opens no such span."""


def read(rec):
    row = rec.get("span_table", {}).get("spans", {}).get("mask")
    units = rec.get("slice_units")
    if not row or not units:
        return None
    return row["host_s"] / units * 1e3
