"""The optimizer's device time per optimizer step, in ms: the device time
of every ``optim.update`` span of the traced segment over the count of
``gan.step`` and ``ae.step`` spans (a GAN step holds two updates), read
from ``mrgan_tpu_torch.utils.profiling.span_table``; training cells only."""


def read(rec):
    if rec["unit"] != "fold-steps":
        return None
    from mrgan_tpu_torch.utils import profiling

    table = getattr(profiling, "span_table", dict)()
    steps = sum(table[n]["count"] for n in ("gan.step", "ae.step")
                if n in table)
    if "optim.update" not in table or not steps:
        return None
    return table["optim.update"]["device_ms"] / steps
