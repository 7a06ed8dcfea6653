"""The log-mel frontend's share of a served request, in %: 100 times the
device time of every ``mel.frontend`` span of the traced segment over that
of every ``serve.request`` span. Read from
``mrgan_tpu_torch.utils.profiling.span_table``; scoring cells only."""


def read(rec):
    if rec["unit"] != "pokes":
        return None
    from mrgan_tpu_torch.utils import profiling

    table = getattr(profiling, "span_table", dict)()
    if "mel.frontend" not in table or "serve.request" not in table:
        return None
    request = table["serve.request"]["device_ms"]
    if request <= 0:
        return None
    return 100.0 * table["mel.frontend"]["device_ms"] / request
