"""The part of a training call that is not its steps, in %: 100 times one
less the device time of every ``gan.step`` and ``ae.step`` span over that
of every ``loo.call`` and ``ae.call`` span of the traced segment (the
set's upload, the host's fold choice, fold prep, initialisation and the
test pass, which a deeper run would amortise). Read from
``mrgan_tpu_torch.utils.profiling.span_table``; training cells only."""


def read(rec):
    if rec["unit"] != "fold-steps":
        return None
    from mrgan_tpu_torch.utils import profiling

    table = getattr(profiling, "span_table", dict)()

    def device_ms(names):
        return sum(table[n]["device_ms"] for n in names if n in table)

    calls = device_ms(("loo.call", "ae.call"))
    steps = device_ms(("gan.step", "ae.step"))
    if calls <= 0 or steps <= 0:
        return None
    return 100.0 * (1.0 - steps / calls)
