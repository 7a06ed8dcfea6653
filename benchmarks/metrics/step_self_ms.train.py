"""A step's own device time, in ms: the self device time (less the child
spans', chiefly ``optim.update``) of every ``gan.step`` and ``ae.step``
span of the traced segment over their count: draws, gathers, forward and
backward passes, losses. Read from
``mrgan_tpu_torch.utils.profiling.span_table``; training cells only."""


def read(rec):
    if rec["unit"] != "fold-steps":
        return None
    from mrgan_tpu_torch.utils import profiling

    table = getattr(profiling, "span_table", dict)()
    rows = [table[n] for n in ("gan.step", "ae.step") if n in table]
    count = sum(r["count"] for r in rows)
    if not count:
        return None
    return sum(r["self_device_ms"] for r in rows) / count
