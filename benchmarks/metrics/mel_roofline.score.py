"""The log-mel frontend's share of its roofline, in %: the frozen
``mel_bound`` of one request's frames over the device time of
``ops/mel.py::frontend_logmel`` on that request's audio (CUDA events at the
function's boundary, so it reads the same work whatever implements it)."""


def read(rec):
    s = rec["spans"]
    if "frontend_s" not in s or s["frontend_s"] <= 0:
        return None
    return 100.0 * s["frontend_bound_s"] / s["frontend_s"]
