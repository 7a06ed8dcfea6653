"""The share of the traced segment in which no operation ran on the
device, in %, for the cells whose unit of work is pokes."""


def read(rec):
    t = rec["trace"]
    if rec["unit"] != "pokes" or not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
