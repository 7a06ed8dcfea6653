"""The window's training rate as a share of the card's float32 peak, in %:
the yardstick's operations of one fold-step (the configuration's matrix
products, ``yardstick.py``) times the fold-steps a second, over the CUDA
cores' 67 TFLOP/s (the configurations state float32 with TF32 off)."""

from yardstick import FP32_PEAK


def read(rec):
    if rec["unit"] != "fold-steps":
        return None
    rate = rec["window"]["work"] / rec["window"]["seconds"]
    return 100.0 * rec["flops_per_unit"] * rate / FP32_PEAK
