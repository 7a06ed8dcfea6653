"""Numeric policy on the card: full float32 everywhere.

The counterpart of the JAX package's ``Precision.HIGHEST``. TF32 keeps about
three decimal digits; one reduced-precision pass of the DFT is up to ~5 dB
off the golden log-mel fixtures (``mrgan_tpu/ops/mel_pallas.py:82-86``), so
a plain path in TF32 would miss every parity bar the port is held to.
"""

import torch


def resolve(name):
    """``name`` ("cuda", "cuda:1", "cpu") as a ``torch.device``. A CUDA
    device without a card raises: nothing falls back to the CPU."""
    dev = torch.device(name)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("the port runs on cuda or cpu, got %s" % dev)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device %s was asked for, but no CUDA device is "
                           "available (torch.cuda.is_available() is False)"
                           % dev)
    return dev


def set_fp32_policy():
    """Turn TF32 off for matmuls and cuDNN; return a line that says so."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return ("numeric policy: fp32 (torch.backends.cuda.matmul.allow_tf32=%s, "
            "torch.backends.cudnn.allow_tf32=%s)"
            % (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32))
