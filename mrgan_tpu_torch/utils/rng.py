"""Random number generators of the trainer.

Port of ``mrgan_tpu/utils/rng.py``. The JAX package splits one key per fold;
here the folds of a launch are a leading tensor axis, so one
``torch.Generator`` on the launch's device draws for all of them. Its seed
is the same ``rng.randint(2**31 - 1)`` draw of the protocol's numpy stream
(``mrgan_tpu/train/protocol.py:250``), and nothing else is drawn from that
stream, so the folds and labeled rows the numpy stream picks next stay the
JAX package's. The two libraries' random streams differ by design: parity
of the stochastic parts is statistical.
"""

import torch


def make_generator(seed, device):
    """A generator on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen
