#!/usr/bin/env python3
"""Which row centre the mel kernel's bf16x3 mode should take, on the CPU.

The kernel takes a constant c off every frame of a row and adds c times each
basis column's sum back: exact algebra, but at precision "high" the frames
less c are what the bf16 split rounds. This runs the plain bf16x3 version
of the kernel's function (``ops/mel_cuda.py::mel_power_reference`` with
``center``) with three centres against the float64 mel power, on the
request windows of ``chip_smoke.py`` (ADC counts, and the same less 2,048)
and on 100 ADC windows of phase 11's shape:

- none (c = 0, the Pallas kernel's function);
- the row mean (the HIGHEST kernel's centre);
- the row mean rounded to an integer (``row_centers(..., "high")``).

For each it prints the powers outside the kernel check's bars (rtol 2e-4 /
atol 2e-3) of float64 and the largest log-mel distance from float64, and
the fp32 plain path's for comparison.

    python tools/mel_high_centring.py      # ~1 min on 8 CPU threads
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mrgan_tpu_torch.ops import mel, mel_cuda  # noqa: E402


def report(name, audio):
    n = len(audio)
    padded = mel.reflect_pad(audio, cs.N_FFT).contiguous()
    tn = mel.num_frames(audio.shape[1], cs.HOP)
    frames = padded.unfold(-1, cs.N_FFT, cs.HOP).reshape(-1, cs.N_FFT)
    truth = cs.mel_power_f64(frames)
    truth_db = mel.db_scale(truth.reshape(n, tn, 128))
    centres = {"none": None,
               "mean": padded.mean(1).repeat_interleave(tn),
               "rounded mean": mel_cuda.row_centers(padded, "high")
               .repeat_interleave(tn)}
    for label, c in centres.items():
        p = mel_cuda.mel_power_reference(frames, precision="high", center=c)
        outside = ((p.double() - truth).abs()
                   > cs.POWER_ATOL + cs.POWER_RTOL * truth.abs()).sum().item()
        db = (mel.db_scale(p.reshape(n, tn, 128)).double()
              - truth_db).abs().max().item()
        print("%-24s bf16x3, centre %-13s powers outside the bars of "
              "float64: %6d of %d; max log-mel distance %.5f dB"
              % (name, label, outside, p.numel(), db))
    fp32 = mel.db_scale(mel_cuda.mel_power_reference(frames)
                        .reshape(n, tn, 128))
    print("%-24s fp32 plain: max log-mel distance %.5f dB"
          % (name, (fp32.double() - truth_db).abs().max().item()))


def main():
    torch.set_num_threads(8)
    windows = cs.request_windows(72, seed=0)
    contact = torch.from_numpy(windows["contact"])
    report("requests less 2,048", contact - 2048.0)
    report("requests, ADC counts", contact)
    report("phase 11's ADC windows", torch.from_numpy(
        cs.adc_windows(100, cs.AUDIO_LEN, seed=3)))
    report("random, 1 s", torch.from_numpy(
        np.random.RandomState(1).randn(8, 48000).astype(np.float32) * 100))


if __name__ == "__main__":
    main()
