"""Kernels launched in the traced segment over the optimizer steps it ran
(every fold of a launch in one step), fold prep, initialisation and the
final test pass included."""


def read(rec):
    t = rec["trace"]
    if rec["unit"] != "fold-steps" or not t or not t["steps"]:
        return None
    return t["launches"] / t["steps"]
