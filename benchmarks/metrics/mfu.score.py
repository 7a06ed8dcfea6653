"""The window's scoring rate as a share of the card's float32 peak, in %:
the yardstick's operations of one poke (its log-mel frames as
``mel_bound`` counts them and the discriminator's forward) times the pokes
a second, over 67 TFLOP/s."""

from yardstick import FP32_PEAK


def read(rec):
    if rec["unit"] != "pokes":
        return None
    rate = rec["window"]["work"] / rec["window"]["seconds"]
    return 100.0 * rec["flops_per_unit"] * rate / FP32_PEAK
