"""Pokes classified in the window, over the window's wall time; scoring
cells only."""


def read(rec):
    if rec["unit"] != "pokes":
        return None
    return rec["window"]["work"] / rec["window"]["seconds"]
