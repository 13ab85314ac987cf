"""The device milliseconds a round of the work that the host launched
inside the program span sniper/mask (the inference mask branch: the 14x14
pool, the mask head, the plane pick and the softmax) over the traced
slice, by benchmark/core/spans.table. None under a program that opens no
such span."""


def read(rec):
    row = rec.get("span_table", {}).get("spans", {}).get("mask")
    units = rec.get("slice_units")
    if not row or not units:
        return None
    return row["device_s"] / units * 1e3
