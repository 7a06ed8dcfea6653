"""Seconds from the start of the run's script to the window's start:
imports, inputs and weights made on the card, the kernels' build or load,
the warm-up and the correctness capture."""


def read(rec):
    return rec["setup_s"]
