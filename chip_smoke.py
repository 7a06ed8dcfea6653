"""Drive the PyTorch port's serving and training paths once on one NVIDIA GPU
and check them.

    python3 chip_smoke.py        # from the repository root, one CUDA device

Phases (any failure raises and the script exits non-zero):

1. The card (``nvidia-smi`` name and power limit) and the fp32 numeric policy.
2. Build ``mrgan_tpu_torch/csrc/mel_power.cu`` and ``csrc/lstm_scan.cu``
   with nvcc for sm_90a, side by side.
3. The kernel against its plain PyTorch version on the card: every variant
   (tile and bin grouping) the wrapper can pick, at F = 19, 114, 1,368,
   5,700 and 48,128 frames and on unaligned rows (F = 30), within the mel
   power bars and bitwise equal over two launches; then the picked variant at F = 70 and on 72 / 300 /
   500 / 512 request windows, log-mel within 0.02 dB, and the golden
   librosa-0.5.1 fixtures within 7e-3 dB through ``frontend_logmel``.
4. The full-width modality-5 classifier (3,712 features: temperature +
   force0 + force1 at 4 s, log-mel of 0.2 s of contact mic): seeded random
   discriminator, scaler fit on 72 seeded windows, save -> load, then
   requests of 1, 6 and 72 pokes through ``classify_pokes`` and one raw poke
   through ``classify_raw_poke``, counting the launches of both kernels
   (the DFT kernel and the bin-group sum); each request's logits are held
   to a run of the plain mel path.
5. Times from CUDA events (median of 20 runs after warm-up): requests, and
   kernel vs plain at F = 19, 114, 1,368 and 48,128; beside them the device
   time of the same calls from ``torch.profiler`` (the sum of their
   kernels' durations), which leaves out host time and gives each
   request's device-busy share.
6. The training set through the kernel: ``load_features`` at modality 5 on
   the synthetic set of seed 0, 100 pokes per object (7,200 x 3,632), one
   kernel launch per object (72); the log-mel block held to a plain-path
   build of the same audio under phase 3's rule; wall and device time.
7. The entry point: ``gan_main`` for Table 1 at modality 5, 2 epochs,
   ``--strict``, on the card; 7 cells of 6 fold lines and an average each.
8. One full cell: 100 epochs, 100 % labels, seed 0, 6 folds, on phase 6's
   dataset, held to the JAX package's recorded result
   (``artifacts/t1_sweep.jsonl``) at the repo's DP-parity bars: worst
   per-fold |delta| <= 0.04, |mean delta| <= 1.5 points.
9. ``fit_classifier`` on 600 rows at 2 epochs, save -> load, a request of
   6 pokes through ``classify_pokes``.
10. Training times: updates/s (``bench.py``'s definition) over phase 8's
    wall time; the median step time from CUDA events; device time per step,
    device-busy share, the ten device operations that take the most time
    and kernel launches per step, from ``torch.profiler`` over 50 steps.
11. The kernel at the Table-5 contact-time shapes: 100 pokes of 0.05, 0.1,
    0.3, 0.5, 0.7 and 1 s of ADC audio (F = 500, 1,000, 2,900, 4,700, 6,600
    and 9,400 frames) held to the plain path at phase 3's bars; device time
    of the kernel, the plain path and ``torch.stft`` (cuFFT) + |.|^2 + mel.
12. The GAN tables: Table 3 at full scale through ``run_gan_loo``
    (modality 5, 100 % labels, 1 epoch, 72 objects in 12 launches of 6,
    the labeled rows pinned to the protocol's draw order, peak memory;
    ``ops.scaler.fit_transform_pair`` on 3 of the first launch's folds held
    to the same call on the CPU at 1e-5 of the scaled range); the peak memory
    of the widest Table-5 launch (6 folds x 12,032 features); ``gan_main
    --tables 3 5 6`` and ``--tables 1 -v`` at 10 pokes per object, their
    printed structure checked.
13. The MLP baseline: the 100-epoch, 50 %-label, seed-0 modality-5 cell
    held to ``artifacts/t24_nn.jsonl`` at phase 8's bars; updates/s, step
    time, device time and busy share as phase 10 measures them. (The
    100 % cell's 30,000 host-bound steps take over two minutes; the 50 %
    cell has half as many.)
14. The SVM baseline: the 100 %-label, seed-0 modality-5 cell with the
    native solver held to ``artifacts/t2_svm.jsonl`` (libsvm) at 0.03 a
    fold; Gram time on the card and SMO time on the host; then
    ``svm_main --tables 2 4 --deriv`` at 10 pokes per object.
15. ``nn_main --tables 2 4`` at 10 pokes per object, 1 epoch.
16. The LSTM recurrence kernels (``csrc/lstm_scan.cu``: ``lstm_scan_fwd``,
    ``lstm_scan_bwd``) through their autograd Function against the plain
    loop on the card, at the variant paths' shapes (T = 1,280): the
    iwganlstm critic (U = 4, in 1, 128 rows, 1 and 6 folds; a critic
    update's 384 rows), the lstm classifier's three layers (U = 16, in 1
    and 32, 60 and 128 rows, with and without return_sequences) and the
    chain alone (U = 4, in 1, one row); outputs within 1e-5, every
    gradient within rtol 1e-4 / atol 1e-6 (or no further from float64
    than twice the plain loop); every compiled lanes-a-row variant of both
    kernels bit for bit the wrapper's pick; CUDA-event time of each variant
    (20 calls back to back) beside the plain loop's (host-bound, at the
    critic update), cuDNN's LSTM (a yardstick: it computes sigmoid gates)
    and the bound.
17. The variant cells at full width: ``run_wgan_cell`` for iwgan and
    iwganlstm on modality 2 (7,200 x 1,200 -> 1,280, 6 folds stacked, 100
    % labels, seed 0) at the depths of ``artifacts/variant_ref.jsonl`` (the
    JAX package's record): iwgan held to it at the DP-parity bars or the
    record's seed-0 / seed-1 spread where that is wider, every fold 0.1
    below chance; iwganlstm held as one more draw of the record's six
    seeds, every fold strictly below chance (the 0.1-margin verdict
    printed: three of the record's seeds miss it); updates/s, the
    step's CUDA-event median, busy share, top operations and kernel
    launches; the 100-epoch iwganlstm cell's time, predicted from the step.
18. ``wgan_grid -t 0`` for iwgan, iwganlstm, gan, ganlstm, nn and lstm,
    ``-t 1 2 -a iwgan`` and ``--dataset lumini --synthetic -a nn`` at 10
    pokes per object, 1 epoch (through ``run_fold``'s config): the JAX
    CLI's lines, and recurrence-kernel
    launches on exactly the three LSTM algorithms.

19. The autoencoder GAN at full width: ``run_ae_gan_cell`` on the raw
    modality-3 set (7,200 x 9,600 contact samples), 100 % labels, 6 folds,
    seed 0, at the depths of ``artifacts/ae_gan_ref.jsonl`` (AE 10 of 100
    epochs, GAN 100), held to the record's seeds as one more draw of them
    and below chance on every fold (the two-seed verdict and the 0.1-below-
    chance verdict printed: the record itself misses the latter); the AE
    trained: every fold's last-epoch reconstruction MSE below its glorot
    draw's on the same rows (the reference's AE learns nothing of the raw
    waveform, and an untrained AE passes the error bars); the AE
    step's and the GAN-on-encodings step's CUDA-event median, busy share and
    top operations, peak memory, updates/s, the 100-epoch AE cell's
    predicted time; ``cli.autoencoder.main`` at SMOKE_POKES pokes, 1 epoch.
20. The activation maps at full width: ``cli.activation_map`` on modality 2
    (fold 0 of seed 0, the MLP at 10 epochs, 8 samples); its ``.npy`` maps
    against the port's CPU maps from the same parameters (1e-4); the
    planted-feature check of ``tests/test_variants.py`` on the card.
21. The function API: ``protocol.mr_gan`` on the modality-5 set, built
    again through the mel kernel (72 launches), 10 epochs, seed 0: 200 test
    rows a class, the error below chance less 0.1; then the
    ``trainTestSets`` route.
22. ``wgan_grid -t 0 -a svm``, ``-t 0 -a rf`` and ``-t 1 2 -a svm`` on the
    default (native) routes at SMOKE_POKES pokes: the lines of
    ``artifacts/grid_svm_rf_ref.jsonl`` (the JAX CLI with scikit-learn), the
    SVM within 0.03 a fold (one row on a 10-row leave-one-object-out fold),
    the forest's mean within 0.05 and every fold above chance + 0.1; the
    Gram, SMO and forest-fit times.
23. Preprocessing: ``generate_raw_file`` pickles (6 materials x 2 objects x
    4 pokes) through ``cli.preprocess.main`` on the card, configs 0 and 7,
    every array within 1e-5 of its range of a ``device="cpu"`` run, the
    output read back by ``mreo.load_features``.
24. The mel kernel at precision "high" (bf16x3, ``MRGAN_MEL_PRECISION=high``)
    against its plain version: every variant the wrapper can pick at phase
    3's shapes, power within rtol 2e-4 / atol 2e-3 of the plain bf16x3
    version of the kernel's function (its row centring on the rows' means
    rounded to integers written out, which moves the bf16 split's rounding)
    and bitwise equal over two launches,
    log-mel within 0.02 dB of the plain bf16x3 version without the centring
    (the Pallas kernel's function); the golden fixtures through
    ``frontend_logmel`` within 0.1 dB; ``load_features`` at modality 5 (72
    launches) within 0.1 dB of phase 6's build; times at F = 19, 114, 1,368
    and 48,128 beside the HIGHEST kernel, the plain bf16x3 path, the cuFFT
    route, the bound and the bf16 algorithm bound.
25. The live collection entry point: ``cli.collect.main`` on the card with
    ``--classifier`` on phase 9's checkpoint, 6 pokes at timescale 20 over
    the firmware simulators (built with g++ at the start, beside the
    kernels): a prediction for every poke; the saved raw pickle classified
    again offline gives the same predictions and logits within 1e-4; the
    same pokes under ``MRGAN_MEL_PRECISION=high`` launch the HIGH kernel once
    a poke, their logits within the classifier's Lipschitz bound of their
    log-mel gap from the HIGHEST ones (that gap within 0.1 dB); the
    per-poke classification latency from CUDA events and the wall time.
26. bf16 weight shadows (``matmul_weight_dtype="bfloat16"``): a recorded
    step of phase 8's set (its 18 weight reads bit for bit the masters'
    bf16 round, its 9 weight gradients bf16), then phase 8's cell with
    shadows, in a process of its own, held to phase 8's errors at the
    DP-parity bars.
27. Two gloo ranks sharing the card (spawned, a file store under
    ``build/chip_smoke/``), run beside phase 26's cell while this process
    runs phases 20-23 and 12c (24-25, which time a kernel and a poke, run
    first) and the rest: (a) phase 8's cell through the sweep route (folds 3 + 3) held
    to phase 8 at the DP-parity bars, whether bit for bit printed; (b) the
    data-parallel step, 25 rows a rank, fed one process's draws: the first
    update within 3e-4 (float32 weights) / 3e-3 (shadows), its losses
    1e-5, the tenth printed; then the cell at ``DP_EPOCHS`` held as one
    more draw of one process's fold layouts at that depth (the DP-parity
    verdict against one launch printed); (c) ``logmel_sharded`` over phase
    3's 72-window request (padded to 20 frames) and the 512 x 1 s block,
    each rank's block through the mel kernel, within 0.02 dB of
    ``frontend_logmel``; (d) the TP pair at 3,632 -> 1,000 -> 500 within
    1e-5 of the dense pair; (e) ``torch.distributed.run --nproc-per-node
    2`` of the table CLI (modality 5, 10 pokes, 1 epoch): rank 0 prints
    phase 7's lines (numbers aside), rank 1 nothing, the checkpoint once.
28. NCCL at world size 1: the sweep and data-parallel entry points return
    one process's cell bit for bit (1 epoch); rank 1 of 2 is refused
    cuda:1; two NCCL ranks on cuda:0 raise at their first collective.
29. The paper figures: ``reports.plots.sample_trace_data`` on the card
    (the synthetic set of seed 0), each material's log-mel from one
    ``mel_power`` launch held to the plain ``mel.logmel`` at 0.02 dB; the
    curves of ``artifacts/t1_sweep.jsonl`` and ``t5_sweep.jsonl``; the
    figures through ``cli.plots.main`` where matplotlib or plotly is
    installed, else the ``ImportError`` that names both.
30. The SVM zoo and PCA: the grid's -t 0 folds of modality 2 (6 folds of
    seed 54321, ``scale="scale"``, half of each class's train rows
    labeled, ~3,000 a fold), ``learn_svm`` kernels 0-4 on their native
    routes (the folds side by side in threads: the SMOs release the
    interpreter lock), each fold within 0.03 of
    ``artifacts/svm_zoo_ref.jsonl`` (the JAX package's scikit-learn runs,
    ``tools/svm_zoo_ref.py``); ``pca_scale(pca=100)`` on the card within
    1e-4 of the range of the CPU route's, its explained variance within
    rtol 1e-4 of the record's.
31. The double backward of the recurrence (``lstm_scan_adj``,
    ``lstm_scan_bwd_ext``): the Petzka penalty's parameter gradients at
    the iwganlstm critic's full width (6 folds x 128 mixed rows, T =
    1,280, U 4, in 1, final state; the head scaled so that every row's
    gradient norm passes 1) and at a U = 16 layer, kernels against the
    plain loop on the card at phase 16's bars; every lanes-a-row variant
    of both kernels (the first held to the plain version, the others to
    it bit for bit) timed beside the plain versions, the bound and the
    earlier unstaged kernels' times at the penalty's 12 x 128 rows, and
    again at a critic update's 12 x 384; one full-width ``disc_step`` with
    ``petzka_lp=True`` held the same way; a 2-epoch ``run_wgan_cell`` with
    it (errors, the share of updates with the penalty active, step time;
    no JAX record holds it).

The kernel counts are set to 0 just before each path is driven (phase 4,
then phases 6-7, phase 9's request, each path of phases 12-15, 17-18,
19-25, 27 and 29-31; the ranks of phase 27 count in their own processes
and return their counts) and read just after; the JSON line's
``launches`` is their sum.
Phases 19, 20, 22, 23 and 30 launch no kernel, and check that they do
not. Launches made to compare a kernel with its plain version or to time
it are not counted.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA
device.
"""

import contextlib
import dataclasses
import io
import json
import math
import os
import pickle
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from mrgan_tpu_torch import MATERIALS
from mrgan_tpu_torch.acquisition import serialdev
from mrgan_tpu_torch.cli import activation_map as am_cli
from mrgan_tpu_torch.cli import autoencoder as ae_cli
from mrgan_tpu_torch.cli import collect as collect_cli
from mrgan_tpu_torch.cli import plots as plots_cli
from mrgan_tpu_torch.cli import preprocess as prep_cli
from mrgan_tpu_torch.cli import tables, wgan_grid
from mrgan_tpu_torch.data import mreo, preprocess, py2pickle, synthetic
from mrgan_tpu_torch.models import losses, nets
from mrgan_tpu_torch.models import variant_nets as vnets
from mrgan_tpu_torch.ops import (features, lstm, lstm_cuda, mel, mel_cuda,
                                 scaler)
from mrgan_tpu_torch.reports import plots
from mrgan_tpu_torch.serve import MaterialClassifier, fit_classifier
from mrgan_tpu_torch.train import gan, mlp, optim, protocol, svm
from mrgan_tpu_torch.utils import device as numeric
from mrgan_tpu_torch.utils import rng as rng_util
from mrgan_tpu_torch.utils import tree
from mrgan_tpu_torch.variants import (activation_maps, autoencoder,
                                      baselines, wgan)

ROOT = Path(__file__).resolve().parent
FIXDIR = ROOT / "tests" / "golden" / "fixtures"
OUT_DIR = ROOT / "build" / "chip_smoke"

FT_TIME, C_TIME = 4.0, 0.2
FT_LEN, AUDIO_LEN = int(100 * FT_TIME), int(48000 * C_TIME)  # 400, 9600
FULL_DIM = 3712          # 3 * 400 + 128 * 19 = 3632, padded to 128s
HOP, N_FFT = 512, 2048
POWER_RTOL, POWER_ATOL = 2e-4, 2e-3   # tests/test_mel_pallas.py:22
DB_ATOL = 0.02                        # tests/test_mel_pallas.py:31
GOLDEN_DB_ATOL = 7e-3                 # tests/test_mel.py:115
ROUNDING_ATOL = 1e-4                  # fp32 matmul rounding in the logits
RUNS, WARMUP = 20, 3
REFERENCE = ROOT / "artifacts" / "t1_sweep.jsonl"
NN_REFERENCE = ROOT / "artifacts" / "t24_nn.jsonl"
SVM_REFERENCE = ROOT / "artifacts" / "t2_svm.jsonl"
FOLD_DELTA, MEAN_DELTA = 0.04, 0.015  # STATUS.md:29, tools/dp_parity.py
SVM_FOLD_DELTA = 0.03                 # tests/test_native_svm.py:93
SCALER_PAIR_RTOL = 1e-5  # fit_transform_pair, card vs CPU, of the range
SCALER_PAIR_FOLDS = 3    # of a launch's 6: the check took 1.2 s on all 6
PROFILE_STEPS = 50
C_TIMES = (0.05, 0.1, 0.3, 0.5, 0.7, 1.0)  # Table 5's, less phase 6's 0.2 s
SMOKE_POKES = 10
# H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W): TF32 and bf16 on
# the tensor cores, float32 on the CUDA cores, HBM3 bytes
TF32_PEAK, BF16_PEAK, FP32_PEAK, HBM_BYTES_S = 495e12, 989e12, 67e12, 3.35e12
HIGH_DB_ATOL = 0.1     # tests/test_mel_pallas.py:45, the Pallas kernel's HIGH
SIMS = ("thermal_sim", "contactmic_sim")


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, runs=RUNS, warmup=WARMUP):
    """Median milliseconds of fn() between two CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def stream_ms(fn, runs=RUNS, warmup=1):
    """Milliseconds per call of ``runs`` calls of fn() queued back to back
    between two CUDA events: the host's launch time hides behind the device
    work of the calls before it, where each call's device work is longer."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def device_ms(fn, runs=RUNS):
    """Milliseconds the device spends in the kernels fn() launches, from
    torch.profiler, per call (None if the profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", 0) for e in prof.key_averages())
    return total / 1e3 / runs if total > 0 else None


def fmt_ms(ms):
    return "not measured" if ms is None else "%.4f ms" % ms


def request_windows(n, seed):
    """n seeded poke windows at the classifier's widths, shaped like the
    collection stack's streams after windowing: temperature in degC, force
    taxels in N, contact mic in 12-bit ADC counts around 2048."""
    rng = np.random.RandomState(seed)
    t = np.arange(FT_LEN) / 100.0
    drop = rng.uniform(1, 8, (n, 1))
    temperature = 55.0 - drop * (1 - np.exp(-np.maximum(t - 0.1, 0) / 1.5))
    peak = rng.uniform(3, 7, (n, 1))
    force = peak * np.clip((t - 0.1) / 0.05, 0, 1)
    tc = np.arange(AUDIO_LEN) / 48000.0 - C_TIME / 2
    burst = (rng.uniform(0.2, 1.0, (n, 1)) * 200.0
             * np.exp(-np.maximum(tc, 0) * rng.uniform(20, 80, (n, 1)))
             * np.sin(2 * np.pi * rng.uniform(300, 6000, (n, 1)) * tc)
             * (tc >= 0))
    contact = np.round(2048.0 + burst + 2.0 * rng.randn(n, AUDIO_LEN))
    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    return {
        "temperature": f32(temperature + 0.05 * rng.randn(n, FT_LEN)),
        "force0": f32(force + 0.05 * rng.randn(n, FT_LEN)),
        "force1": f32(0.8 * force + 0.05 * rng.randn(n, FT_LEN)),
        "contact": f32(contact),
    }


def raw_poke(seed, record_s=5.5, impact_s=0.8):
    """One poke in the collection stack's raw save schema (the keys
    classify_raw_poke reads), irregularly sampled, float64."""
    rng = np.random.RandomState(seed)

    def times(rate):
        n = int(record_s * rate)
        return np.sort(np.arange(n) / rate + rng.uniform(0, 0.2 / rate, n))

    t_f, t_t, t_c = times(1000.0), times(100.0), times(48000.0)
    force = np.zeros((len(t_f), 5))
    base = 5.0 * np.clip((t_f - impact_s) / 0.05, 0, 1)
    force[:, 3] = base + 0.05 * rng.randn(len(t_f))
    force[:, 4] = 0.8 * base + 0.05 * rng.randn(len(t_f))
    celsius = 55.0 - 4.0 * (1 - np.exp(-np.maximum(t_t - impact_s, 0) / 1.5))
    temp = np.stack([np.round(celsius * 37 + 500), celsius], axis=1)
    tc = t_c - impact_s
    mic = np.round(2048.0 + 150.0 * np.exp(-np.maximum(tc, 0) * 40)
                   * np.sin(2 * np.pi * 1500 * tc) * (tc >= 0)
                   + 2.0 * rng.randn(len(t_c)))
    return {"RGripRFingerForce": [force], "RGripRFingerTime": [t_f],
            "temperatureRaw": [temp], "temperatureTime": [t_t],
            "contactmic": [mic], "contactmicTime": [t_c],
            "collisionTime": [impact_s]}


def on(dev, windows):
    return {k: torch.from_numpy(v).to(dev) for k, v in windows.items()}


def check_close(name, got, want, rtol, atol):
    err = (got - want).abs().max().item()
    torch.testing.assert_close(
        got, want, rtol=rtol, atol=atol,
        msg=lambda m: "%s: max_abs_err %r\n%s" % (name, err, m))
    return err


def mel_power_f64(frames):
    """The plain three matmuls in float64: the truth both fp32 paths are
    measured against."""
    cw, sw, melw = (torch.from_numpy(np.ascontiguousarray(a)).to(frames.device)
                    for a in mel._dft_mel_bases(48000, N_FFT, 128,
                                                np.float64))
    f = frames.double()
    re, im = f @ cw, f @ sw
    return (re * re + im * im) @ melw


def framed_input(dev, windows, n, audio_len, seed=1):
    """Zero-mean audio for n windows: the request windows less the ADC
    midpoint at 0.2 s, seeded random audio for the 1 s frontend shape.
    Returns the reflect-padded rows, frames per row and the (F, n_fft)
    frames as a view."""
    audio = (windows["contact"] - 2048.0 if audio_len == AUDIO_LEN else
             torch.from_numpy(np.random.RandomState(seed).randn(
                 n, audio_len).astype(np.float32) * 100).to(dev))
    audio = audio.repeat(-(-n // len(audio)), 1)[:n].contiguous()
    padded = mel.reflect_pad(audio, N_FFT).contiguous()
    return (padded, mel.num_frames(audio_len, HOP),
            padded.unfold(-1, N_FFT, HOP).reshape(-1, N_FFT))


# (windows, samples each) for F = 19, 114, 1,368, 5,700 and 48,128 frames,
# and F = 30 from rows of 4,801 + 2,048 samples, which are not 16-byte
# aligned (the kernel's 4-byte copies)
VARIANT_SHAPES = ((1, AUDIO_LEN), (6, AUDIO_LEN), (72, AUDIO_LEN),
                  (300, AUDIO_LEN), (512, 48000), (3, 4801))


def variants_vs_plain(dev, windows, sms):
    """Phase 3a: every (tile, groups) variant the wrapper can pick, held to
    the plain path at the mel power bars, twice, bitwise equal."""
    checked = 0
    for n, audio_len in VARIANT_SHAPES:
        padded, tn, frames = framed_input(dev, windows, n, audio_len)
        f = n * tn
        want = mel_cuda.mel_power_reference(frames)
        for layout in mel_cuda.variants(f, sms):
            before = mel_cuda.launches, mel_cuda.reduce_launches
            run = lambda: mel_cuda._launch(  # noqa: E731
                padded, padded.shape[1], tn, HOP, f, 48000, N_FFT, 128,
                layout=layout)
            got, again = run(), run()
            torch.cuda.synchronize()
            assert (mel_cuda.launches - before[0],
                    mel_cuda.reduce_launches - before[1]) == (
                        2, 2 * (layout[1] > 1)), layout
            name = "F=%d %s" % (f, mel_cuda.describe(layout, f))
            err = check_close(name, got, want, POWER_RTOL, POWER_ATOL)
            assert torch.equal(got, again), name + ": repeat launch differs"
            print("variant %s%s: max_abs_err=%r (rtol %g, atol %g), repeat "
                  "bitwise equal" % (
                      name, " [picked]" if layout == mel_cuda._layout(f, sms)
                      else "", err, POWER_RTOL, POWER_ATOL))
            checked += 1
    return checked


def kernel_vs_plain(dev, windows, sms):
    """Phase 3; returns the kernel's log-mel dB error against the plain path
    on the main path's 72 request windows."""
    frames = torch.from_numpy(
        np.random.RandomState(0).randn(70, N_FFT).astype(np.float32)).to(dev)
    got = mel_cuda.mel_power(frames)
    torch.cuda.synchronize()
    err = check_close("mel_power F=70", got,
                      mel_cuda.mel_power_reference(frames), POWER_RTOL,
                      POWER_ATOL)
    print("mel_power F=70 %s max_abs_err=%r (rtol %g, atol %g)"
          % (mel_cuda.describe(mel_cuda._layout(70, sms), 70), err,
             POWER_RTOL, POWER_ATOL))

    # The bars hold for zero-mean audio: the request windows less the ADC
    # midpoint, and random audio for the 1 s frontend shape. With the ADC's
    # 2048-count DC left in, both fp32 paths lose ~1e-3 of the weak bins'
    # power to the DC term's rounding (measured against float64 below).
    for n, audio_len in ((72, AUDIO_LEN), (300, AUDIO_LEN), (500, AUDIO_LEN),
                         (512, 48000)):
        padded, tn, frames = framed_input(dev, windows, n, audio_len)
        got = mel_cuda.mel_power_framed(padded, tn, HOP)
        want = mel_cuda.mel_power_reference(frames)
        torch.cuda.synchronize()
        err = check_close("mel_power_framed F=%d" % (n * tn), got, want,
                          POWER_RTOL, POWER_ATOL)
        truth = mel_power_f64(frames)
        rel = [((x.double() - truth).abs() / truth.abs().clamp(min=1e-30))
               .max().item() for x in (got, want)]
        print("mel_power_framed F=%d %s max_abs_err=%r (rtol %g, atol %g); "
              "max rel err vs float64: kernel %r, plain %r"
              % (n * tn, mel_cuda.describe(mel_cuda._layout(n * tn, sms),
                                           n * tn), err, POWER_RTOL,
                 POWER_ATOL, rel[0], rel[1]))

    centered = windows["contact"] - 2048.0
    t = mel.num_frames(AUDIO_LEN, HOP)
    err = check_close("logmel 72 zero-mean", mel_cuda.logmel(centered),
                      mel.logmel(centered), 0, DB_ATOL)
    print("logmel 72x%d zero-mean max_abs_err_db=%r (atol %g dB)"
          % (AUDIO_LEN, err, DB_ATOL))

    # the main path's own windows, DC included: the kernel must be within
    # the bar of the plain path, or no further from float64 than twice the
    # plain path's own distance
    audio = windows["contact"]
    got_db = mel_cuda.logmel(audio)
    want_db = mel.logmel(audio)
    frames = mel._frame(audio, N_FFT, HOP)
    truth_db = mel.db_scale(mel_power_f64(frames.reshape(-1, N_FFT))
                            .reshape(72, t, 128))
    torch.cuda.synchronize()
    assert got_db.shape == (72, 128 * t)
    db_err = (got_db - want_db).abs().max().item()
    k_err = (got_db.double() - truth_db).abs().max().item()
    p_err = (want_db.double() - truth_db).abs().max().item()
    print("logmel 72x%d ADC counts: kernel vs plain max_abs_err_db=%r; vs "
          "float64: kernel %r dB, plain %r dB" % (AUDIO_LEN, db_err, k_err,
                                                   p_err))
    assert db_err <= DB_ATOL or k_err <= 2 * p_err, (db_err, k_err, p_err)

    worst = 0.0
    names = sorted(p.name[3:-4] for p in FIXDIR.glob("in_*.npy"))
    assert len(names) >= 6, names
    for name in names:
        x = torch.from_numpy(np.load(FIXDIR / ("in_%s.npy" % name))[None]
                             .astype(np.float32)).to(dev)
        want = torch.from_numpy(np.load(FIXDIR / ("logmel_%s.npy" % name))
                                .astype(np.float32)).to(dev)
        before = mel_cuda.launches
        got = mel.frontend_logmel(x, flatten=False)[0]
        assert mel_cuda.launches == before + 1, "fixture skipped the kernel"
        worst = max(worst, check_close("golden " + name, got, want, 0,
                                       GOLDEN_DB_ATOL))
    print("golden fixtures x%d via frontend_logmel max_abs_err_db=%r "
          "(atol %g dB)" % (len(names), worst, GOLDEN_DB_ATOL))
    return db_err


def lipschitz(disc):
    """Product of the dense layers' spectral norms: relu is 1-Lipschitz, so
    |logits(a) - logits(b)| <= this * ||a - b||_2 for scaled inputs a, b."""
    bound = 1.0
    for name in ["d%d" % i for i in range(len(disc.widths))] + ["mid", "out"]:
        bound *= torch.linalg.matrix_norm(getattr(disc, name).weight,
                                          ord=2).item()
    return bound


# -- the training path ---------------------------------------------------------

def training_set(dev, pokes=100):
    """Phase 6: the modality-5 training set built on the card, the kernel
    making its log-mel block, held to the plain path under phase 3's rule.
    Returns (X, y) on the card."""
    kw = dict(modalities=5, synthetic_seed=0,
              synthetic_kwargs={"pokes_per_object": pokes})
    before = mel_cuda.launches
    t0 = time.perf_counter()
    x, y = mreo.load_features(device=dev, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_obj = len(MATERIALS) * 12
    assert mel_cuda.launches - before == n_obj, mel_cuda.launches - before
    n_trace = 3 * FT_LEN
    t = mel.num_frames(AUDIO_LEN, HOP)
    assert x.shape == (n_obj * pokes, n_trace + 128 * t) and x.device == dev, (
        x.shape, x.device)
    assert torch.isfinite(x).all()

    # the same audio (the loader's memo) through the plain path and float64
    synth = mreo._generate_processed_memo(
        seed=0, forcetemp_time=4, contactmic_time=C_TIME,
        pokes_per_object=pokes)
    contact = torch.cat([torch.from_numpy(obj["contact"]) for m in MATERIALS
                         for obj in synth[m].values()]).to(dev)
    plain, truth = [], []
    for rows in contact.split(pokes):
        plain.append(mel.logmel(rows))
        frames = mel._frame(rows, N_FFT, HOP).reshape(-1, N_FFT)
        truth.append(mel.db_scale(mel_power_f64(frames).reshape(-1, t, 128)))
    plain, truth = torch.cat(plain), torch.cat(truth)
    got = x[:, n_trace:]
    db_err = (got - plain).abs().max().item()
    k_err = (got.double() - truth).abs().max().item()
    p_err = (plain.double() - truth).abs().max().item()
    print("phase 6: load_features modality 5, %d pokes: X %s on %s, %d kernel "
          "launches (one per object, F=%d each), wall %.3f s; log-mel block "
          "kernel vs plain max_abs_err_db=%r; vs float64: kernel %r dB, "
          "plain %r dB" % (len(x), tuple(x.shape), x.device,
                            mel_cuda.launches - before, pokes * t, wall,
                            db_err, k_err, p_err))
    assert db_err <= DB_ATOL or k_err <= 2 * p_err, (db_err, k_err, p_err)
    return x, y, synth, contact


def training_kernel_times(contact, pokes=100):
    """Device time of the kernel at the training path's shape (one object,
    F = 1,900) against the plain path, and of the 72 objects' log-mel.
    Run after the path's counts are read: these launches do not count."""
    t = mel.num_frames(AUDIO_LEN, HOP)
    padded = mel.reflect_pad(contact[:pokes], N_FFT).contiguous()
    frames = padded.unfold(-1, N_FFT, HOP).reshape(-1, N_FFT)
    bound, bound_by, gemm = mel_bound(pokes, padded.shape[1], pokes * t)
    print("phase 6 times: kernel device time %s per object (F=%d), plain %s, "
          "cuFFT route %s; bound %.4f ms (%s), algorithm bound (DFT as a "
          "3xTF32 GEMM) %.4f ms; %s for the log-mel of the %d objects" % (
              fmt_ms(device_ms(lambda: mel_cuda.mel_power_framed(
                  padded, t, HOP))), pokes * t,
              fmt_ms(device_ms(lambda: mel_cuda.mel_power_reference(frames))),
              fmt_ms(device_ms(lambda: stft_mel_power(contact[:pokes]))),
              bound, bound_by, gemm,
              fmt_ms(device_ms(lambda: [mel_cuda.logmel(rows) for rows in
                                        contact.split(pokes)], runs=1)),
              len(contact) // pokes))


def entry_point(dev_name, epochs=2, pokes=100):
    """Phase 7: Table 1 through ``gan_main`` at modality 5, on the card."""
    argv = ["--tables", "1", "--synthetic", "--seed", "0", "--modalities",
            "5", "--epochs", str(epochs), "--strict", "--device", dev_name,
            "--synthetic-pokes", str(pokes)]
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        tables.gan_main(argv)
    wall = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    print("\n".join(lines))
    subheads = [l for l in lines if "Percentage of training data" in l]
    folds = [l for l in lines if l.startswith("Test error:")]
    averages = [l for l in lines if l.startswith("Average error:")]
    assert len(subheads) == len(averages) == 7 and len(folds) == 42, (
        len(subheads), len(folds), len(averages))
    assert "Force, Temperature, and Contact Mic modality" in lines[3], lines[3]
    errs = [float(l.split()[2]) for l in folds]
    assert all(0.0 <= e <= 1.0 for e in errs), errs
    print("phase 7: gan_main %s: 7 cells x 6 folds, wall %.3f s"
          % (" ".join(argv), wall))
    return lines


def reference_errors(path=REFERENCE, model="gan", table=1, percent=100):
    """The JAX package's recorded fold errors of a modality-5 cell."""
    cell = {"model": model, "table": table, "modality": 5, "percent": percent}
    for line in path.read_text().splitlines():
        rec = json.loads(line) if line.strip() else {}
        if rec.get("cell", {}) == cell:
            return np.asarray(rec["result"])
    raise KeyError("no cell %s in %s" % (cell, path))


def hold_to_reference(name, errs, want, fold_bar, mean_bar,
                      ref_name="JAX package"):
    """Print and check per-fold errors against a recorded cell."""
    delta = errs - want
    print("%s: port %s, %s %s; mean %.4f vs %.4f, worst |delta| %.4f (bar "
          "%g), |mean delta| %.2f points (bar %s)" % (
              name, np.round(errs, 4).tolist(), ref_name,
              np.round(want, 4).tolist(), errs.mean(), want.mean(),
              np.abs(delta).max(), fold_bar, 100 * abs(delta.mean()),
              "none" if mean_bar is None else "%.1f" % (100 * mean_bar)))
    assert np.isfinite(errs).all() and errs.shape == want.shape, errs
    assert np.abs(delta).max() <= fold_bar, delta
    assert mean_bar is None or abs(delta.mean()) <= mean_bar, delta


def full_cell(ds, epochs=100):
    """Phase 8: the 100-epoch, 100 %-label, seed-0 cell against the JAX
    package's recorded result. Returns (errors, wall seconds, updates)."""
    cfg = gan.GanConfig(epochs=epochs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    errs = protocol.run_gan_cell(ds, percentlabeled=100, cfg=cfg, seed=0)
    wall = time.perf_counter() - t0
    n_train = len(ds) - len(ds) // 6
    updates = 6 * epochs * (n_train // cfg.batch_size)
    hold_to_reference(
        "phase 8: modality 5, 100 %% labels, %d epochs, seed 0 vs %s (wall "
        "%.3f s)" % (epochs, REFERENCE.relative_to(ROOT), wall), errs,
        reference_errors(), FOLD_DELTA, MEAN_DELTA)
    return errs, wall, updates


def fitted_classifier(dev, x, y, synth):
    """Phase 9: fit_classifier -> save -> load -> classify_pokes on the card.
    Returns the (DFT, bin-group sum) launches of the request and the
    checkpoint's path."""
    rows = torch.arange(0, len(x), 12, device=dev)
    clf = fit_classifier(x[rows], y[rows], modality=5,
                         cfg=gan.GanConfig(epochs=2), seed=0, ft_time=FT_TIME,
                         c_time=C_TIME, device=dev)
    path = clf.save(str(OUT_DIR / "clf_fit"))
    served = MaterialClassifier.load(path, device=dev)
    pokes = {k: np.stack([synth[m]["%s_obj0" % m][k][0] for m in MATERIALS])
             for k in ("temperature", "force0", "force1", "contact")}
    mel_cuda.launches = mel_cuda.reduce_launches = 0
    names = served.classify_pokes(**pokes)
    counted = mel_cuda.launches, mel_cuda.reduce_launches
    assert len(names) == 6 and set(names) <= set(MATERIALS), names
    assert counted[0] == 1, counted
    print("phase 9: fit_classifier on %d rows, 2 epochs, saved to %s and "
          "reloaded; 6 pokes (one per material %s) -> %s; %d kernel launch"
          % (len(rows), Path(path).relative_to(ROOT), list(MATERIALS), names,
             counted[0]))
    return counted, path


def time_steps(step, warmup=10, runs=60):
    """``step(b)``'s median milliseconds between CUDA events, then from
    torch.profiler over PROFILE_STEPS steps: device ms per step, device
    operations per step and the operations sorted by device time."""
    from torch.profiler import ProfilerActivity, profile

    for b in range(warmup):
        step(b)
    times = []
    for b in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(b)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for b in range(PROFILE_STEPS):
            step(b)
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages()
           if getattr(e, "device_time_total", 0) > 0]
    busy = sum(e.device_time_total for e in ops) / 1e3 / PROFILE_STEPS
    per_step = sum(e.count for e in ops) / PROFILE_STEPS
    return (statistics.median(times), busy, per_step,
            sorted(ops, key=lambda e: -e.device_time_total))


def print_top_ops(label, ops, n=10):
    print("%s: top device operations per step:" % label)
    for e in ops[:n]:
        print("  %8.4f ms  %5.1f/step  %s" % (
            e.device_time_total / 1e3 / PROFILE_STEPS,
            e.count / PROFILE_STEPS, e.key[:110]))


def fold_tensors(ds, percent, n_items=4):
    """Phase 8's folds (seed 0) as (F, n) int64 index tensors on the card:
    (lab, pool, train, test)[:n_items]."""
    rng = np.random.RandomState(0)
    splits = protocol.stratified_splits(ds.y_host, 6, seed=0)
    idx = [protocol.fold_indices(ds.y_host, tr, te, percent, None, 6, rng)
           for tr, te in splits]
    return [torch.as_tensor(np.stack([f[i] for f in idx]).astype(np.int64),
                            device=ds.X.device) for i in range(n_items)]


def step_times(ds, cell):
    """Phase 10: updates/s of phase 8, then the step alone: CUDA-event
    median, and device time, busy share, top operations and launches per
    step from torch.profiler."""
    errs, wall, updates = cell
    print("phase 10: %d updates (6 folds x epochs x 120 batches) in %.3f s: "
          "%.1f updates/s (phase 7 ran the same path first, as a warm-up)"
          % (updates, wall, updates / wall))
    cfg = gan.GanConfig()
    lab, pool, train, test = fold_tensors(ds, 100)
    data = gan.scale_folds(ds.X, ds.y, lab, pool, train, test)
    generator = rng_util.make_generator(0, ds.X.device)
    state = gan.init_state(gan.init_params(generator, ds.X.shape[1], cfg, 6),
                           cfg)
    li, ui, u2i = gan.epoch_schedule(generator, 6, lab.shape[1],
                                     pool.shape[1], train.shape[1],
                                     cfg.batch_size)
    nb = li.shape[1]

    def step(b):
        nonlocal state
        rand = gan.draw_step(generator, 6, cfg.batch_size, ds.X.shape[1], cfg)
        state, _ = gan.train_step(state, data, li[:, b % nb], ui[:, b % nb],
                                  u2i[:, b % nb], rand, cfg=cfg)

    step_ms, busy, per_step, ops = time_steps(step)
    print("phase 10: step (6 folds, batch 50, D=%d): median %.4f ms of 60 "
          "(CUDA events, one step's draws included; %.1f updates/s); device "
          "time %s per step over %d steps (torch.profiler): device busy "
          "%.1f%% of the step; %.1f device operations per step" % (
              ds.X.shape[1], step_ms, 6e3 / step_ms, fmt_ms(busy),
              PROFILE_STEPS, 100 * busy / step_ms, per_step))
    print_top_ops("phase 10", ops)


# -- the kernel's bound and its library route ----------------------------------

def mel_bound(n_rows, row_len, frames):
    """The least time the card could take for the mel power of ``frames``
    frames of n_rows padded audio rows of row_len samples, counting the work
    the function needs, not the kernel's way of doing it: the larger of the
    bytes (the audio and the filterbank's nonzero weights read once, the
    mel output written once) over HBM's rate, and the float32 operations
    over the CUDA cores' peak. Per frame: the window (N), a real FFT of
    N = 2048 points (2.5 N log2 N, half the radix-2 complex count), the
    power (3 a bin) and the projection onto the filterbank's nonzero
    weights (2 each).

    Returns (ms, "bytes" or "operations", the algorithm bound of the
    kernel's method: its DFT as a GEMM of 3xTF32 products plus the dense
    projection, at the TF32 peak, in ms)."""
    n_bins = N_FFT // 2 + 1
    nonzero = int(np.count_nonzero(mel.mel_filterbank(48000, N_FFT, 128)))
    per_frame = (N_FFT + 2.5 * N_FFT * math.log2(N_FFT) + 3 * n_bins
                 + 2 * nonzero)
    ops_s = per_frame * frames / FP32_PEAK
    nbytes = 4 * (n_rows * row_len + nonzero + frames * 128)
    bytes_s = nbytes / HBM_BYTES_S
    gemm = 3 * 2 * 2 * N_FFT * n_bins * frames + 2 * n_bins * 128 * frames
    return (1e3 * max(ops_s, bytes_s),
            "operations" if ops_s >= bytes_s else "bytes",
            1e3 * gemm / TF32_PEAK)


def stft_mel_power(audio):
    """The library route to the same function: torch.stft (cuFFT, centered,
    reflect-padded, periodic hann) -> |.|^2 -> the mel matmul; (B, N)
    audio -> (B * T, 128), frame-major like ``mel_power_framed``."""
    window = torch.hann_window(N_FFT, periodic=True, device=audio.device)
    spec = torch.stft(audio, N_FFT, hop_length=HOP, window=window,
                      center=True, pad_mode="reflect", return_complex=True)
    power = torch.view_as_real(spec).square().sum(-1)   # (B, bins, T)
    melw = mel.bases(48000, N_FFT, 128, audio.device)[2]
    return (power.transpose(1, 2) @ melw).reshape(-1, 128)


def adc_windows(n, audio_len, seed):
    """n contact-mic windows of audio_len samples in 12-bit ADC counts
    around 2048, shaped like phase 4's request windows: a decaying tone
    burst from the window's middle on, plus noise."""
    rng = np.random.RandomState(seed)
    tc = (np.arange(audio_len) - audio_len // 2) / 48000.0
    burst = (rng.uniform(0.2, 1.0, (n, 1)) * 200.0
             * np.exp(-np.maximum(tc, 0) * rng.uniform(20, 80, (n, 1)))
             * np.sin(2 * np.pi * rng.uniform(300, 6000, (n, 1)) * tc)
             * (tc >= 0))
    return np.round(2048.0 + burst + 2.0 * rng.randn(n, audio_len)).astype(
        np.float32)


def table5_shapes(dev, sms, pokes=100):
    """Phase 11: the kernel at each Table-5 contact time (one launch per
    object of 100 pokes), held to the plain path: power on zero-mean audio,
    log-mel on zero-mean audio, and on raw ADC counts against float64;
    device time of the kernel, the plain path and the cuFFT route."""
    worst = 0.0
    for c_time in C_TIMES:
        n = int(48000 * c_time)
        t = mel.num_frames(n, HOP)
        f = pokes * t
        audio = torch.from_numpy(adc_windows(pokes, n, seed=t)).to(dev)
        centered = audio - 2048.0
        padded = mel.reflect_pad(centered, N_FFT).contiguous()
        frames = padded.unfold(-1, N_FFT, HOP).reshape(-1, N_FFT)
        want = mel_cuda.mel_power_reference(frames)
        err = check_close("F=%d power" % f,
                          mel_cuda.mel_power_framed(padded, t, HOP), want,
                          POWER_RTOL, POWER_ATOL)
        db_err = check_close("F=%d log-mel" % f, mel_cuda.logmel(centered),
                             mel.logmel(centered), 0, DB_ATOL)
        got_db, plain_db = mel_cuda.logmel(audio), mel.logmel(audio)
        truth_db = mel.db_scale(mel_power_f64(
            mel._frame(audio, N_FFT, HOP).reshape(-1, N_FFT)).reshape(
                pokes, t, 128))
        raw_err = (got_db - plain_db).abs().max().item()
        k_err = (got_db.double() - truth_db).abs().max().item()
        p_err = (plain_db.double() - truth_db).abs().max().item()
        assert raw_err <= DB_ATOL or k_err <= 2 * p_err, (f, raw_err, k_err,
                                                          p_err)
        lib_err = check_close("F=%d cuFFT route" % f, stft_mel_power(centered),
                              want, POWER_RTOL, POWER_ATOL)
        worst = max(worst, db_err)
        bound, bound_by, gemm = mel_bound(pokes, padded.shape[1], f)
        times = [device_ms(fn) for fn in (
            lambda: mel_cuda.mel_power_framed(padded, t, HOP),
            lambda: mel_cuda.mel_power_reference(frames),
            lambda: stft_mel_power(centered))]
        print("phase 11: c_time %.2f s, F=%d (%s): power max_abs_err=%r; "
              "log-mel zero-mean %r dB; ADC counts: vs plain %r dB, vs "
              "float64 kernel %r dB, plain %r dB; cuFFT route vs plain "
              "max_abs_err=%r. Device time: kernel %s, plain %s, cuFFT route "
              "%s; bound %.4f ms (%s), algorithm bound (DFT as a 3xTF32 "
              "GEMM) %.4f ms" % (
                  c_time, f, mel_cuda.describe(mel_cuda._layout(f, sms), f),
                  err, db_err, raw_err, k_err, p_err, lib_err,
                  *(fmt_ms(x) for x in times), bound, bound_by, gemm))
    return worst


# -- the paths of this slice: tables, baselines ---------------------------------

def driven(fn):
    """fn() with the kernel counts set to 0 just before and read just
    after: (result, DFT kernel launches, bin-group sums)."""
    mel_cuda.launches = mel_cuda.reduce_launches = 0
    result = fn()
    return result, mel_cuda.launches, mel_cuda.reduce_launches


def run_cli(main_fn, argv):
    """main_fn(argv) in-process: (its stdout lines, wall seconds)."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        main_fn(argv)
    return out.getvalue().splitlines(), time.perf_counter() - t0


def count(lines, text, start=False):
    return sum((l.startswith(text) if start else text in l) for l in lines)


def loo_full_scale(dev, pokes=100, percent=100):
    """Phase 12a: Table 3's protocol at full scale on the card. Returns the
    path's kernel launches."""
    kw = dict(modalities=5, synthetic_seed=0, leave_object_out=True,
              synthetic_kwargs={"pokes_per_object": pokes})
    trained, before, orig = [], [], gan.train_folds_indexed

    def record(generator, X, y, lab, pool, train, test, **k):
        trained.append((lab, pool, train, test))
        return orig(generator, X, y, lab, pool, train, test, **k)

    def path():
        objects = mreo.load_features(device=dev, **kw)
        torch.cuda.synchronize()
        before.append(torch.cuda.memory_allocated(dev))
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        gan.train_folds_indexed = record
        try:
            names, errs = protocol.run_gan_loo(
                objects, percent, cfg=gan.GanConfig(epochs=1), seed=0,
                device=dev)
        finally:
            gan.train_folds_indexed = orig
        return objects, names, errs, time.perf_counter() - t0

    (objects, names, errs, wall), launches, _ = driven(path)
    peak = torch.cuda.max_memory_allocated(dev)
    assert launches == 72 and len(objects) == 72, (launches, len(objects))
    assert errs.shape == (72,) and np.isfinite(errs).all(), errs
    assert ((errs >= 0) & (errs <= 1)).all(), errs
    # the pin: what each launch trained is the protocol's draw order
    # (a block's six permutations, then its trainer seed) replayed here
    offs = np.cumsum([0] + [len(objects[n]["y"]) for n in names])
    y_host = torch.cat([objects[n]["y"] for n in names]).cpu().numpy()
    rng = np.random.RandomState(0)
    blocks = []
    for _, idx, _ in protocol.iter_loo_blocks(names, offs, y_host, percent,
                                              6, rng, protocol.loo_chunk(72)):
        blocks.append(idx)
        rng.randint(2**31 - 1)
    assert len(trained) == len(blocks) == 12, len(trained)
    for got, idx in zip(trained, blocks):
        for i, a in enumerate(got):
            np.testing.assert_array_equal(a, np.stack([f[i] for f in idx]))
        lab, _, train, test = got
        for k in range(len(lab)):
            assert np.isin(lab[k], train[k]).all()
            assert not np.isin(test[k], train[k]).any()
    scaler_pair_check(torch.cat([objects[n]["x"] for n in names]),
                      trained[0][2][:SCALER_PAIR_FOLDS],
                      trained[0][3][:SCALER_PAIR_FOLDS])
    print("phase 12a: run_gan_loo modality 5, %d %% labels, 1 epoch, 72 "
          "objects x %d pokes: %d launches of %d items (train %d x %d "
          "rows each), labeled rows pinned to the draw order; mean error "
          "%.4f (min %.4f, max %.4f); %d kernel launches in the loader "
          "(F=%d each); wall %.3f s (training); peak device memory %.3f GB, "
          "%.3f GB of it allocated before the protocol ran"
          % (percent, pokes, len(trained), trained[0][0].shape[0],
             trained[0][2].shape[1], objects[names[0]]["x"].shape[1],
             errs.mean(), errs.min(), errs.max(), launches,
             pokes * mel.num_frames(AUDIO_LEN, HOP),
             wall, peak / 1e9, before[0] / 1e9))
    return launches


def scaler_pair_check(x_all, train, test):
    """Phase 12a: ``ops.scaler.fit_transform_pair`` on the card, on
    SCALER_PAIR_FOLDS folds of the first launch ((F, N, D) train and test
    rows of the loaded features), held to the same call on a CPU copy of
    the rows at SCALER_PAIR_RTOL of the scaled values' range."""
    t0 = time.perf_counter()
    got = scaler.fit_transform_pair(
        *(x_all[torch.as_tensor(i, device=x_all.device)]
          for i in (train, test)))
    assert all(g.device == x_all.device for g in got), got[0].device
    host = x_all.cpu()
    want = scaler.fit_transform_pair(*(host[torch.as_tensor(i)]
                                       for i in (train, test)))
    err = max(float((g.cpu() - w).abs().max()) for g, w in zip(got, want))
    span = (max(float(w.max()) for w in want)
            - min(float(w.min()) for w in want))
    bar = SCALER_PAIR_RTOL * span
    print("phase 12a: fit_transform_pair on %d folds of %d train / %d test "
          "rows x %d: card vs CPU max_abs_err=%r (bar %r: %g of the scaled "
          "range %.4f); %.3f s" % (
              *train.shape, test.shape[1], x_all.shape[1], err, bar,
              SCALER_PAIR_RTOL, span, time.perf_counter() - t0))
    assert err <= bar, (err, bar)


def widest_table5_peak(dev, rows=7200):
    """Phase 12b: the peak memory of the widest Table-5 launch: 6 folds of
    7,200 rows x 12,032 features (contact mic, 1 s), 1 epoch, on seeded
    random features made on the card."""
    width = 128 * mel.num_frames(48000, HOP)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((rows, width), generator=gen, device=dev)
    y = torch.arange(rows, device=dev) % 6
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    errs = protocol.run_gan_cell(x, y, 100, cfg=gan.GanConfig(epochs=1),
                                 seed=0, device=dev)
    wall = time.perf_counter() - t0
    assert errs.shape == (6,) and np.isfinite(errs).all(), errs
    print("phase 12b: widest Table-5 launch, 6 folds of %d x %d, 1 epoch: "
          "peak device memory %.3f GB (%.3f GB allocated before the cell, "
          "the features %.3f GB of it), wall %.3f s" % (
              rows, width, torch.cuda.max_memory_allocated(dev) / 1e9,
              before / 1e9,
              x.numel() * 4 / 1e9, wall))


def smoke_argv(*tables_, extra=()):
    return ["--tables", *tables_, "--synthetic", "--synthetic-pokes",
            str(SMOKE_POKES), "--seed", "0", "--strict", "--device", "cuda",
            *extra]


def gan_tables_cli():
    """Phase 12c: ``gan_main --tables 3 5 6`` and ``--tables 1 -v`` at
    SMOKE_POKES pokes per object. Returns the paths' kernel launches."""
    argv = smoke_argv("3", "5", "6", extra=("--epochs", "1"))
    (lines, wall), launches, _ = driven(lambda: run_cli(tables.gan_main, argv))
    heads = [l.strip("- ") for l in lines if l.startswith("-" * 25 + " Test")]
    assert heads == [
        "Testing generalization with leave-one-object-out validation",
        "Testing various lengths of contact time in training data",
        "Testing various lengths of contact time in training data",
        "Testing performance as quantity of unlabeled data increases"], heads
    objects = [l for l in lines if "_obj" in l and "Test error:" in l]
    assert len(objects) == 72 * 2 * 5, len(objects)  # Table 3's ten cells
    assert count(lines, "Average leave-one-object-out error:", True) == 10
    assert count(lines, "Length of training data:") == 28   # Table 5
    assert count(lines, "Percentage of training data unlabeled:") == 14
    assert count(lines, "Average error:", True) == 28 + 14
    assert count(lines, "Test error:", True) == 6 * (28 + 14)
    # the loader's kernel: Table 3 and Table 6 at modality 5, and Table 5's
    # seven contact-mic durations, one launch per object each
    assert launches == 72 * (1 + 7 + 1), launches
    print("phase 12c: gan_main %s: %d lines, Table 3: 10 cells x 72 objects, "
          "Table 5: 28 cells, Table 6: 14 cells; %d kernel launches; wall "
          "%.3f s" % (" ".join(argv), len(lines), launches, wall))

    argv_v = smoke_argv("1", extra=("--modalities", "5", "--epochs", "2",
                                    "-v"))
    (lines_v, wall_v), launches_v, _ = driven(
        lambda: run_cli(tables.gan_main, argv_v))
    epoch_lines = [l for l in lines_v if l.startswith("Epoch ")]
    assert len(epoch_lines) == 7 * 6 * 2, len(epoch_lines)
    assert count(lines_v, "Test error:", True) == 7 * 6 * 2  # -v and folds
    assert count(lines_v, "Processing ", True) == 6
    assert launches_v == 72, launches_v
    print("phase 12c: gan_main %s: %d epoch lines, e.g. %r; %d kernel "
          "launches; wall %.3f s" % (" ".join(argv_v), len(epoch_lines),
                                     epoch_lines[-1], launches_v, wall_v))
    return launches + launches_v


def mlp_phase(ds, epochs=100, percent=50):
    """Phase 13: the MLP cell against the recorded one, then its step."""
    cfg = mlp.MlpConfig(epochs=epochs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    errs = mlp.run_mlp_cell(ds, percentlabeled=percent, cfg=cfg, seed=0)
    wall = time.perf_counter() - t0
    n_lab = 6 * int(10 * percent)
    updates = 6 * epochs * (n_lab // cfg.batch_size)
    hold_to_reference(
        "phase 13: MLP modality 5, %d %% labels, %d epochs, seed 0 vs %s"
        % (percent, epochs, NN_REFERENCE.relative_to(ROOT)), errs,
        reference_errors(NN_REFERENCE, "nn", 2, percent), FOLD_DELTA,
        MEAN_DELTA)
    print("phase 13: %d updates (6 folds x %d epochs x %d batches) in %.3f s: "
          "%.1f updates/s" % (updates, epochs, n_lab // cfg.batch_size, wall,
                              updates / wall))

    lab, train = fold_tensors(ds, percent, 3)[::2]
    x_lab, = gan.scaled_rows(ds.X, train, lab)
    generator = rng_util.make_generator(0, ds.X.device)
    state = mlp.init_state(generator, ds.X.shape[1], cfg, 6)
    perm, noise = mlp.draw_epoch(generator, 6, x_lab.shape[1], ds.X.shape[1],
                                 cfg)
    rows = torch.arange(6, device=ds.X.device)[:, None, None]
    xb = x_lab[rows, perm].transpose(0, 1).contiguous()
    yb = torch.nn.functional.one_hot(ds.y[lab], 6).float()[rows, perm]
    yb = yb.transpose(0, 1).contiguous()
    nb = perm.shape[1]

    def step(b):
        nonlocal state
        state, _ = mlp.train_step(state, xb[b % nb], yb[b % nb],
                                  [a[b % nb] for a in noise], cfg=cfg)

    step_ms, busy, per_step, ops = time_steps(step)
    print("phase 13: MLP step (6 folds, batch 20, D=%d): median %.4f ms of 60 "
          "(CUDA events; %.1f updates/s); device time %s per step over %d "
          "steps (torch.profiler): device busy %.1f%% of the step; %.1f "
          "device operations per step" % (
              ds.X.shape[1], step_ms, 6e3 / step_ms, fmt_ms(busy),
              PROFILE_STEPS, 100 * busy / step_ms, per_step))
    print_top_ops("phase 13", ops, 6)
    return wall


def svm_phase(x, y):
    """Phase 14: the SVM cell against the recorded one (libsvm), then the
    CLI. Returns the CLI's kernel launches."""
    timings = {}
    errs = svm.run_svm_cell(x, y, 100, seed=0, timings=timings,
                            device=x.device)
    hold_to_reference(
        "phase 14: SVM modality 5, 100 %% labels, seed 0, native SMO vs %s "
        "(libsvm)" % SVM_REFERENCE.relative_to(ROOT), errs,
        reference_errors(SVM_REFERENCE, "svm", 2, 100), SVM_FOLD_DELTA, None)
    gen = torch.Generator(device=x.device).manual_seed(0)
    n_test = len(x) // 6
    a = torch.randn((6, len(x) - n_test, x.shape[1]), generator=gen,
                    device=x.device)
    b = torch.randn((6, n_test, x.shape[1]), generator=gen, device=x.device)
    gram_ms = cuda_ms(lambda: (svm.rbf_kernel(a, a, 1.0 / x.shape[1]),
                               svm.rbf_kernel(b, a, 1.0 / x.shape[1])),
                      runs=5, warmup=1)
    print("phase 14: Gram matrices of the 6 folds (6 x %d^2 and 6 x %d x %d "
          "at D=%d) %.4f ms on the card (CUDA events); in the cell %.3f s "
          "with the host copies; SMO on the host %.3f s (15 pairs x 6 folds)"
          % (a.shape[1], n_test, a.shape[1], x.shape[1], gram_ms,
             timings["gram_s"], timings["solve_s"]))
    del a, b
    argv = smoke_argv("2", "4", extra=("--deriv",))
    (lines, wall), launches, _ = driven(lambda: run_cli(tables.svm_main, argv))
    assert count(lines, "Average error:", True) == 2 * 7, lines[:20]
    assert count(lines, "Average leave-one-object-out error:", True) == 10
    assert len([l for l in lines if "_obj" in l]) == 72 * 10
    assert launches == 72 * 2, launches  # modality 5 in Tables 2 and 4
    print("phase 14: svm_main %s: %d lines, %d kernel launches, wall %.3f s"
          % (" ".join(argv), len(lines), launches, wall))
    return launches


def nn_cli():
    """Phase 15: ``nn_main --tables 2 4``. Returns its kernel launches."""
    argv = smoke_argv("2", "4", extra=("--epochs", "1"))
    (lines, wall), launches, _ = driven(lambda: run_cli(tables.nn_main, argv))
    assert count(lines, "Average error:", True) == 2 * 7, lines[:20]
    assert count(lines, "Average leave-one-object-out error:", True) == 10
    errs = [float(l.split("Test error:")[1].split()[0]) for l in lines
            if "_obj" in l]
    assert len(errs) == 72 * 10 and all(0 <= e <= 1 for e in errs)
    assert launches == 72 * 2, launches
    print("phase 15: nn_main %s: %d lines, %d kernel launches, wall %.3f s"
          % (" ".join(argv), len(lines), launches, wall))
    return launches


# -- this slice: the variant zoo (wganlpctsemi.py) -----------------------------

VARIANT_T = 1280      # modality 2: 3 x 400 features, padded to a multiple of 128
VARIANT_REFERENCE = ROOT / "artifacts" / "variant_ref.jsonl"
# phase 17's depths, recorded by the JAX package on the CPU: the iwgan step
# is host-bound at ~15 ms, so its 200-epoch cell (also recorded) would take
# ~5 minutes here; iwganlstm at 8 epochs (also recorded) sits at chance in
# both packages, so it is held at the least recorded depth where every fold
# of both seeds is clearly below it (at 36 a seed-1 fold read 0.82)
VARIANT_EPOCHS = {"iwgan": 30, "iwganlstm": 60}
CHANCE_ERROR = 5 / 6         # six balanced classes
LEARNED_MARGIN = 0.1         # every fold's error at least this far below it
# iwganlstm failed the two-seed bars at 8 and at 60 epochs: a bar that a
# third draw of the same distribution passes about half the time. It is
# held to the record's seed distribution instead (seed_distribution), and
# the two-seed verdict is printed beside it. Nor is it held 0.1 below
# chance: the record's worst folds over seeds 0-5 at 60 epochs read
# 0.6867, 0.7258, 0.7958, 0.7008, 0.7808, 0.7950, three of six above that
# bar. Every fold is held strictly below chance, the tighter of that and
# seed_distribution's upper fold bound (0.7958 + FOLD_DELTA), as phase 19
# holds the AE-GAN; the 0.1-margin verdict is printed, not held.
TWO_SEED_HELD = ("iwgan",)
T_995 = {3: 5.841, 4: 4.604, 5: 4.032, 6: 3.707, 7: 3.499}  # Student t, df
LSTM_H_ATOL = 1e-5                        # h and logits vs the plain loop
LSTM_GRAD_RTOL, LSTM_GRAD_ATOL = 1e-4, 1e-6
# (label, folds, in, units, rows, return_sequences): the iwganlstm critic
# (a generator update's 128 rows; a critic update's [lab | fake | unl] rows,
# one launch), the lstm classifier's three layers at 60 rows (1 % labels)
# and 128 (its batch), and the chain alone: one row a direction, a step's
# latency with no throughput effects
LSTM_SHAPES = (
    ("iwganlstm critic", 1, 1, 4, 128, False),
    ("iwganlstm critic", 6, 1, 4, 128, False),
    ("iwganlstm critic update [lab|fake|unl]", 6, 1, 4, 384, False),
    ("lstm classifier layer 1", 1, 1, 16, 60, True),
    ("lstm classifier layer 2", 1, 32, 16, 60, True),
    ("lstm classifier layer 3", 1, 32, 16, 60, False),
    ("lstm classifier layer 1", 1, 1, 16, 128, True),
    ("lstm classifier layer 2", 1, 32, 16, 128, True),
    ("lstm classifier layer 3", 1, 32, 16, 128, False),
    ("chain alone", 1, 1, 4, 1, False),
)
MAIN_LSTM_SHAPE = 2   # the critic update: the kernels' numbers in the JSON line
PLAIN_TIMED = (MAIN_LSTM_SHAPE,)  # the plain loop is timed here only (~3 s a run)
GRID_ALGORITHMS = ("iwgan", "iwganlstm", "gan", "ganlstm", "nn", "lstm")
LSTM_ALGORITHMS = ("iwganlstm", "ganlstm", "lstm")


def lstm_counts():
    return lstm_cuda.fwd_launches, lstm_cuda.bwd_launches


def lstm_driven(fn):
    """fn() with the recurrence kernels' counts set to 0 just before and
    read just after: (result, (forward launches, backward launches))."""
    lstm_cuda.fwd_launches = lstm_cuda.bwd_launches = 0
    result = fn()
    return result, lstm_counts()


def lstm_bound(n_seq, steps, rows, in_dim, units, return_sequences,
               backward):
    """The least time for the recurrence's work over n_seq x rows sequences
    of ``steps`` steps: the larger of the bytes (inputs read once, outputs
    written once) over HBM's rate and the float32 operations over the CUDA
    cores' peak. It counts the function, not the kernel's method: x (in
    floats a cell), wx, wh and b, and what a pass must keep or return.
    Forward: x in; the saved gates and cell (5U a cell) out, with h of
    every step (U a cell) under return_sequences, else the last h; a step
    is x @ wx and h @ wh (2 x (in + U) x 4U) and ~12 operations a unit.
    Backward: the saved gates and cell and x in, dh of every step under
    return_sequences, else the last dh; dx (in a cell), dwx, dwh and db
    out; a step is dz @ wh^T, h^T dz, x^T dz and dz @ wx^T (2 x 4U x (2U +
    2 in)) and ~20 operations a unit."""
    cells = n_seq * steps * rows
    gates = 4 * units
    weights = n_seq * (in_dim * gates + units * gates + gates)
    h_out = cells * units if return_sequences else n_seq * rows * units
    if backward:
        flops = cells * (2 * gates * (2 * units + 2 * in_dim) + 20 * units)
        floats = cells * (5 * units + 2 * in_dim) + h_out + 2 * weights
    else:
        flops = cells * (2 * gates * (in_dim + units) + 12 * units)
        floats = cells * (in_dim + 5 * units) + h_out + weights
    ops_s, bytes_s = flops / FP32_PEAK, 4 * floats / HBM_BYTES_S
    return 1e3 * max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s
                                       else "bytes")


def lstm_case(dev, folds, in_dim, units, rows, return_sequences, seed):
    """A seeded biLSTM layer (with the critic's dense head when it returns
    the last state) on (folds, rows, T, in) inputs whose padded tail is
    zero, as the critic's is. Returns (params, x, output weights)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = {"lstm": vnets.bilstm_init(gen, in_dim, units, folds, dev),
              "out": nets.dense_init(gen, 2 * units, 6, dev, (folds,))}
    x = torch.randn((folds, rows, VARIANT_T, in_dim), generator=gen,
                    device=dev)
    if in_dim == 1:
        x[:, :, 3 * FT_LEN:] = 0.0
    out = ((folds, rows, VARIANT_T, 2 * units) if return_sequences
           else (folds, rows, 6))
    return params, x, torch.randn(out, generator=gen, device=dev)


def lstm_route(layer, params, x, w, return_sequences):
    """Output and gradients (x, then every parameter) of sum(out * w)
    through ``layer`` (the kernels' bilstm or the plain loop's)."""
    p = tree.tree_map(lambda a: a.detach().requires_grad_(), params)
    xx = x.detach().requires_grad_()
    out = layer(p["lstm"], xx, return_sequences)
    if not return_sequences:
        out = nets.dense(p["out"], out)
    leaves = [xx] + tree.leaves(p["lstm"]) + (
        [] if return_sequences else tree.leaves(p["out"]))
    grads = torch.autograd.grad((out * w).sum(), leaves)
    return out.detach(), grads


def cudnn_lstm_ms(dev, folds, in_dim, units, rows):
    """ms of torch.nn.LSTM (cuDNN, bidirectional, sigmoid gates: a yardstick
    only) at the same shape, forward and backward: (fwd, bwd)."""
    net = torch.nn.LSTM(in_dim, units, bidirectional=True, device=dev)
    x = torch.randn((VARIANT_T, folds * rows, in_dim), device=dev,
                    requires_grad=True)
    g = torch.randn((VARIANT_T, folds * rows, 2 * units), device=dev)

    def both():
        out, _ = net(x)
        out.backward(g)

    fwd = stream_ms(lambda: net(x))
    return fwd, stream_ms(both) - fwd


def lstm_projection(params, x, units, rows):
    """The biLSTM layer's (xw (S, T, B, 4U), wh (S, U, 4U)) on (F, B, T,
    in) inputs, xw by one matmul as ``LstmScan`` makes it where in > 1."""
    with torch.no_grad():
        wx, wh, b = lstm._both(params["lstm"])
        xw = torch.matmul(x.transpose(1, 2).unsqueeze(1), wx.unsqueeze(2))
        n_seq = 2 * x.shape[0]
        return ((xw + b[:, :, None, None]).reshape(n_seq, VARIANT_T, rows,
                                                   4 * units),
                wh.reshape(n_seq, units, 4 * units))


def lstm_kernel_calls(dev, params, x, units, rows, rs):
    """The two wrapper calls ``LstmScan`` makes for this layer, on the
    saved tensors of one forward: (fwd(lanes), bwd(lanes)). Where in = 1
    the forward takes x, wx and b (the fused projection), else xw from one
    matmul."""
    n_seq = 2 * x.shape[0]
    xw, wh = lstm_projection(params, x, units, rows)
    with torch.no_grad():
        if x.shape[-1] == 1:
            wx, _, b = lstm._both(params["lstm"])
            inputs = dict(xw=None, x=x[..., 0].transpose(1, 2).contiguous(),
                          wx=wx.reshape(n_seq, 4 * units).contiguous(),
                          b=b.reshape(n_seq, 4 * units).contiguous())
        else:
            inputs = dict(xw=xw)
        _, _, zs, c = lstm_cuda.lstm_scan_fwd(wh=wh, dirs=2, **inputs)
        dh = torch.randn((n_seq, rows, units), device=dev)
        dh_seq = (torch.randn((n_seq, VARIANT_T, rows, units), device=dev)
                  if rs else None)

    def fwd(lanes):
        with torch.no_grad():
            return lstm_cuda.lstm_scan_fwd(wh=wh, dirs=2, lanes=lanes,
                                           **inputs)

    def bwd(lanes):
        with torch.no_grad():
            return lstm_cuda.lstm_scan_bwd(dh_seq, None if rs else dh, zs, c,
                                           wh, 2, lanes=lanes)

    return fwd, bwd


def same_bits(a, b):
    """Two kernel results (tensors or tuples of them, None where not
    written) are equal bit for bit."""
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip(a, b))


def lstm_kernels_vs_plain(dev):
    """Phase 16: both kernels through the autograd Function against the
    plain loop on the card, at the variant paths' shapes; every compiled
    lanes-a-row variant of both, bit for bit against the wrapper's pick,
    and its CUDA-event time; the plain loop and cuDNN's LSTM beside them;
    the bound. Returns the JSON fields of both kernels."""
    worst_h = worst_g = 0.0
    timing = {}
    for k, (label, folds, in_dim, units, rows, rs) in enumerate(LSTM_SHAPES):
        params, x, w = lstm_case(dev, folds, in_dim, units, rows, rs, seed=k)
        before = lstm_counts()
        out_k, g_k = lstm_route(vnets.bilstm_apply, params, x, w, rs)
        assert lstm_counts() == (before[0] + 1, before[1] + 1), lstm_counts()
        out_p, g_p = lstm_route(lstm.bilstm_reference, params, x, w, rs)
        torch.cuda.synchronize()
        name = "%s F=%d in=%d U=%d B=%d%s" % (
            label, folds, in_dim, units, rows, " sequences" if rs else "")
        h_err = check_close(name + " output", out_k, out_p, 0, LSTM_H_ATOL)
        g_err, by_f64 = 0.0, []
        names = ["dx"] + ["d" + "/".join(kk)
                          for kk in tree_paths(params["lstm"])]
        g64 = None
        for i, (gname, a, b) in enumerate(zip(names + ["dhead"] * 2, g_k,
                                              g_p)):
            err = (a - b).abs().max().item()
            if not torch.allclose(a, b, rtol=LSTM_GRAD_RTOL,
                                  atol=LSTM_GRAD_ATOL):
                # a sum over T x B terms taken in another order: the kernel
                # route must then be within the bar's atol of float64, or
                # no further from it than twice the plain loop is (phase
                # 3's rule for the mel kernel)
                if g64 is None:
                    g64 = lstm_route(lstm.bilstm_reference,
                                     tree.tree_map(torch.Tensor.double,
                                                   params),
                                     x.double(), w.double(), rs)[1]
                k64 = (a.double() - g64[i]).abs().max().item()
                p64 = (b.double() - g64[i]).abs().max().item()
                assert k64 <= max(2 * p64, LSTM_GRAD_ATOL), (
                    name, gname, err, k64, p64)
                by_f64.append("%s: %.3g vs plain, %.3g / %.3g from float64"
                              % (gname, err, k64, p64))
            g_err = max(g_err, err)
        worst_h, worst_g = max(worst_h, h_err), max(worst_g, g_err)

        # the kernels alone, every lanes-a-row variant, on the saved
        # tensors of one forward: bit for bit the wrapper's pick
        n_seq = 2 * folds
        fwd, bwd = lstm_kernel_calls(dev, params, x, units, rows, rs)
        pick = lstm_cuda.default_lanes(units, n_seq, rows)
        want = (fwd(pick), bwd(pick))
        lanes_ms = {}
        for lanes in lstm_cuda.LANES[units]:
            assert same_bits(fwd(lanes), want[0]), (name, "fwd", lanes)
            assert same_bits(bwd(lanes), want[1]), (name, "bwd", lanes)
            lanes_ms[lanes] = (stream_ms(lambda: fwd(lanes)),
                               stream_ms(lambda: bwd(lanes)))
        fwd_ms, bwd_ms = lanes_ms[pick]
        plain = (None, None)
        if k in PLAIN_TIMED:  # host-bound: the device idles between steps
            xw, wh = lstm_projection(params, x, units, rows)
            rev = lstm.reverse_mask(False, n_seq, 2, dev)
            xg = xw.detach().requires_grad_()

            def plain_both():
                h = lstm.lstm_scan_reference(xg, wh, rev, rs)
                h.backward(torch.ones_like(h))

            with torch.no_grad():
                p_fwd = stream_ms(lambda: lstm.lstm_scan_reference(
                    xw, wh, rev, rs), runs=1, warmup=0)
            plain = (p_fwd, stream_ms(plain_both, runs=1, warmup=0) - p_fwd)
        lib = cudnn_lstm_ms(dev, folds, in_dim, units, rows)
        bounds = [lstm_bound(n_seq, VARIANT_T, rows, in_dim, units, rs, bwd_)
                  for bwd_ in (False, True)]
        timing[k] = {"fwd": (fwd_ms, plain[0], lib[0], bounds[0]),
                     "bwd": (bwd_ms, plain[1], lib[1], bounds[1])}
        print("phase 16: %s: output max_abs_err=%r (atol %g), gradients "
              "max_abs_err=%r (rtol %g, atol %g%s); CUDA-event ms a call "
              "(%d kernel and cuDNN calls back to back, one plain loop), "
              "%d lanes a row (the wrapper's pick): forward kernel %.4f ms "
              "(%.1f ns a step), plain loop %s, cuDNN %.4f ms (a "
              "yardstick: sigmoid gates), bound %.4f ms (%s; the kernel at "
              "%.1f %%); backward kernel %.4f ms (%.1f ns a step), plain "
              "loop %s, cuDNN %.4f ms, bound %.4f ms (%s; %.1f %%)" % (
                  name, h_err, LSTM_H_ATOL, g_err, LSTM_GRAD_RTOL,
                  LSTM_GRAD_ATOL,
                  "; past it, within twice the plain loop's distance from "
                  "float64: " + ", ".join(by_f64) if by_f64 else "", RUNS,
                  pick, fwd_ms, 1e6 * fwd_ms / VARIANT_T, fmt_ms(plain[0]),
                  lib[0], *bounds[0], 100 * bounds[0][0] / fwd_ms, bwd_ms,
                  1e6 * bwd_ms / VARIANT_T, fmt_ms(plain[1]), lib[1],
                  *bounds[1], 100 * bounds[1][0] / bwd_ms))
        print("phase 16: %s: lanes a row, every variant bit for bit the "
              "pick's: %s" % (name, "; ".join(
                  "%d: forward %.4f ms (%.1f ns a step), backward %.4f ms "
                  "(%.1f ns a step)" % (lanes, f, 1e6 * f / VARIANT_T, b_,
                                        1e6 * b_ / VARIANT_T)
                  for lanes, (f, b_) in lanes_ms.items())))
    main = timing[MAIN_LSTM_SHAPE]
    # no PyTorch call computes this function (cuDNN's LSTM has sigmoid
    # gates, Keras's hard_sigmoid), so library_ms is null
    return {
        "lstm_scan_fwd": dict(max_abs_err=worst_h, ms=main["fwd"][0],
                              plain_ms=main["fwd"][1],
                              bound_ms=main["fwd"][3][0],
                              bound_by=main["fwd"][3][1],
                              library_ms=None),
        "lstm_scan_bwd": dict(max_abs_err=worst_g, ms=main["bwd"][0],
                              plain_ms=main["bwd"][1],
                              bound_ms=main["bwd"][3][0],
                              bound_by=main["bwd"][3][1],
                              library_ms=None),
    }


def tree_paths(t, prefix=()):
    """Key paths of a nested dict in ``tree.leaves`` order."""
    if isinstance(t, dict):
        return [p for k in sorted(t) for p in tree_paths(t[k], prefix + (k,))]
    return [prefix]


def variant_reference(algorithm):
    """The JAX package's recorded cells of ``algorithm`` at phase 17's depth
    (tools/record_variant_ref.py): (epochs, batch size, {seed: errors})."""
    recs = [json.loads(l) for l in VARIANT_REFERENCE.read_text().splitlines()
            if l.strip()]
    recs = [r for r in recs if r["cell"]["algorithm"] == algorithm
            and r["cell"]["epochs"] == VARIANT_EPOCHS[algorithm]]
    cell = recs[0]["cell"]
    assert all(r["cell"] == cell for r in recs), recs
    return (cell["epochs"], cell["batch_size"],
            {r["seed"]: np.asarray(r["result"]) for r in recs})


def seed_spread(ref):
    """The record's own seed-0 / seed-1 spread: the largest |difference| of
    one fold's error, and the |difference| of the mean errors."""
    a, b = ref[0], ref[1]
    return float(np.abs(a - b).max()), abs(float(a.mean() - b.mean()))


def below_chance(name, errs):
    """A critic that learns nothing reads ~5/6 on every fold: each fold must
    be at least LEARNED_MARGIN below that."""
    assert errs.max() <= CHANCE_ERROR - LEARNED_MARGIN, (name, errs)


def seed_distribution(name, errs, ref, what="the record's %d seeds"):
    """The cell as one more draw of the record's seeds: its mean error
    inside the 99 % prediction interval of the recorded seeds' means (mean
    +- t(0.995, n - 1) * sd * sqrt(1 + 1 / n)), every fold inside the
    range of the recorded folds widened by the DP-parity fold bar."""
    means = np.array([e.mean() for e in ref.values()])
    n = len(means)
    half = T_995[n - 1] * means.std(ddof=1) * math.sqrt(1 + 1 / n)
    folds = np.concatenate(list(ref.values()))
    lo, hi = folds.min() - FOLD_DELTA, folds.max() + FOLD_DELTA
    print("%s: held to %s: mean %.4f vs their %.4f (sd %.4f), bar +-%.4f "
          "(99 %% prediction interval); folds %.4f-%.4f vs theirs "
          "%.4f-%.4f, bar %.4f-%.4f" % (
              name, what % n, errs.mean(), means.mean(), means.std(ddof=1),
              half, errs.min(), errs.max(), folds.min(), folds.max(), lo,
              hi))
    assert abs(errs.mean() - means.mean()) <= half, (name, errs, means)
    assert lo <= errs.min() and errs.max() <= hi, (name, errs, lo, hi)


def two_seed_verdict(name, errs, want, fold_bar, mean_bar):
    """Print the cell against the seed-0 record at the two-seed bars, the
    verdict reported, not held."""
    delta = errs - want
    inside = (np.abs(delta).max() <= fold_bar
              and abs(delta.mean()) <= mean_bar)
    print("%s: port %s, JAX package %s; worst |delta| %.4f (bar %.4f), "
          "|mean delta| %.2f points (bar %.2f): %s the two-seed bars "
          "(reported, not held)" % (
              name, np.round(errs, 4).tolist(), np.round(want, 4).tolist(),
              np.abs(delta).max(), fold_bar, 100 * abs(delta.mean()),
              100 * mean_bar, "inside" if inside else "OUTSIDE"))


def variant_cell(x2, y2, algorithm):
    """Phase 17: the full-width cell (6 folds stacked) at the recorded
    depth, against the JAX package's seed-0 record at the DP-parity bars,
    or at the record's own seed-0 / seed-1 spread where that is wider: held
    there for the cells of TWO_SEED_HELD, reported for the others and held
    to :func:`seed_distribution`. The record's seed 0 clearly below chance
    on every fold (:func:`below_chance`, LEARNED_MARGIN below it); the
    cells of TWO_SEED_HELD too, the others strictly below chance on every
    fold, with the margin's verdict printed, not held (the record's other
    seeds miss it). Returns (wall seconds, updates, LSTM kernel
    launches)."""
    epochs, bs, ref = variant_reference(algorithm)
    below_chance("the record of %s, seed 0" % algorithm, ref[0])
    cfg = wgan_grid.algorithm_config(algorithm, epochs)
    assert cfg.batch_size == bs, (cfg.batch_size, bs)
    fold_spread, mean_spread = seed_spread(ref)
    fold_bar = max(FOLD_DELTA, fold_spread)
    mean_bar = max(MEAN_DELTA, mean_spread)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    errs, launches = lstm_driven(lambda: wgan.run_wgan_cell(
        x2, y2, 1.0, cfg=cfg, seed=0, device=x2.device))
    wall = time.perf_counter() - t0
    n_train = len(y2) - len(y2) // 6
    updates = 6 * epochs * (n_train // bs)
    name = "phase 17: %s modality 2 (%d x %d -> %d), 100 %% labels, %d " \
        "epochs, batch %d, seed 0 vs %s seed 0 (its seed-0 / seed-1 " \
        "spread: worst fold %.4f, mean %.2f points)" % (
            algorithm, *x2.shape, VARIANT_T, epochs, bs,
            VARIANT_REFERENCE.relative_to(ROOT), fold_spread,
            100 * mean_spread)
    if algorithm in TWO_SEED_HELD:
        hold_to_reference(name, errs, ref[0], fold_bar, mean_bar)
        below_chance("phase 17 " + algorithm, errs)
    else:
        two_seed_verdict(name, errs, ref[0], fold_bar, mean_bar)
        seed_distribution("phase 17 " + algorithm, errs, ref)
        record_max = [float(e.max()) for _, e in sorted(ref.items())]
        print("phase 17: %s: every fold below chance (%.4f): port max %.4f "
              "(held); the 0.1-below-chance bar (%.4f) is %s by the port and "
              "met by %d of the record's %d seeds (worst folds %s) (reported, "
              "not held)" % (
                  algorithm, CHANCE_ERROR, errs.max(), LEARNED_BAR,
                  "met" if errs.max() <= LEARNED_BAR else "missed",
                  sum(m <= LEARNED_BAR for m in record_max), len(record_max),
                  np.round(record_max, 4).tolist()))
        assert errs.max() < CHANCE_ERROR, (algorithm, errs)
    print("phase 17: %s: %d updates (6 folds x %d epochs x %d batches) in "
          "%.3f s: %.1f updates/s; LSTM kernel launches %s (forward, "
          "backward)" % (algorithm, updates, epochs, n_train // bs, wall,
                         updates / wall, launches))
    return wall, updates, launches


def variant_step_times(dev, algorithm):
    """Phase 17: one training step of the full-width cell (6 folds, D =
    1,280, seeded random rows): CUDA-event median, busy share, top
    operations, LSTM kernel launches per step. Returns the median ms."""
    cfg = wgan_grid.algorithm_config(algorithm, 1)
    gen = torch.Generator(device=dev).manual_seed(0)
    n = 6000
    data = {"x_labeled": torch.randn((6, n, VARIANT_T), generator=gen,
                                     device=dev),
            "y_labeled": torch.randint(0, 6, (6, n), generator=gen,
                                       device=dev),
            "pool": torch.randn((6, n, VARIANT_T), generator=gen, device=dev)}
    state = wgan.init_state(wgan.init_params(gen, VARIANT_T, cfg, 6))
    idx = wgan.epoch_schedule(gen, 6, n, n, n, cfg)
    nb = idx["lab"].shape[1]

    def step(b):
        nonlocal state
        state, _ = wgan.train_step(
            state, data, idx["lab"][:, b % nb], idx["unl_d"][:, b % nb],
            idx["unl_g"][:, b % nb], wgan.draw_step(gen, 6, cfg), cfg=cfg)

    (step_ms, busy, per_step, ops), launches = lstm_driven(
        lambda: time_steps(step))
    n_steps = 10 + 60 + PROFILE_STEPS
    print("phase 17: %s step (6 folds, batch %d, D=%d): median %.4f ms of 60 "
          "(CUDA events, the step's draws included; %.1f updates/s); device "
          "time %s per step over %d steps (torch.profiler): device busy "
          "%.1f%% of the step; %.1f device operations per step; LSTM kernel "
          "launches per step %.1f forward, %.1f backward" % (
              algorithm, cfg.batch_size, VARIANT_T, step_ms, 6e3 / step_ms,
              fmt_ms(busy), PROFILE_STEPS, 100 * busy / step_ms, per_step,
              launches[0] / n_steps, launches[1] / n_steps))
    print_top_ops("phase 17 %s" % algorithm, ops, 8)
    return step_ms


def full_depth_prediction(y2, step_ms):
    """Phase 17: the 100-epoch iwganlstm cell (the grid's depth) has no
    record to hold it to, so it is not run; its time is predicted from the
    step median."""
    cfg = wgan_grid.algorithm_config("iwganlstm")
    updates = cfg.epochs * ((len(y2) - len(y2) // 6) // cfg.batch_size)
    print("phase 17: the %d-epoch iwganlstm cell (%d steps of 6 folds) is "
          "predicted at %.1f s from the step median; not run (no record at "
          "that depth)" % (cfg.epochs, updates, updates * step_ms / 1e3))


def grid_argv(device, *args):
    return ["--synthetic", "--synthetic-pokes", str(SMOKE_POKES), "--device",
            device, *args]


@contextlib.contextmanager
def grid_depth(epochs):
    """wgan_grid.main's trainers cut to ``epochs``: the CLI keeps the
    reference's flags, so the depth goes in through run_fold's cfg=."""
    run_fold = wgan_grid.run_fold
    wgan_grid.run_fold = lambda algorithm, *a, **k: run_fold(
        algorithm, *a, cfg=wgan_grid.algorithm_config(algorithm, epochs), **k)
    try:
        yield
    finally:
        wgan_grid.run_fold = run_fold


def check_grid_t0(lines, algorithm, grid_points=1):
    """The -t 0 lines of the JAX package's wgan_grid.main: the title, per
    grid point a Parameters line, 6 fold accuracies and their average; then
    the best score."""
    assert lines[0] == wgan_grid.TITLES[algorithm], lines[:2]
    assert count(lines, "Parameters:", True) == grid_points, lines[:3]
    accs = [float(l.split()[-1]) for l in lines
            if l.startswith("Test accuracy:")]
    assert len(accs) == 6 * grid_points and all(0 <= a <= 1 for a in accs)
    assert count(lines, "Average accuracy:", True) == grid_points
    assert count(lines, "Percent labeled:", True) == 1
    assert count(lines, "Best score:", True) == 1
    assert count(lines, "Best parameters:", True) == 1
    assert lines[-1].startswith("Total time:"), lines[-1]
    return accs


def grid_cli(device="cuda"):
    """Phase 18: the grid CLI on the card at SMOKE_POKES pokes an object (the
    caller sets the depth, :func:`grid_depth`): -t 0 for each GPU-capable algorithm, -t 1 2 for iwgan, and the
    synthetic Lumini set through nn. Returns the LSTM kernels' launches."""
    total = [0, 0]
    for algorithm in GRID_ALGORITHMS:
        argv = grid_argv(device, "-t", "0", "-a", algorithm)
        (lines, wall), launches = lstm_driven(
            lambda: run_cli(wgan_grid.main, argv))
        accs = check_grid_t0(lines, algorithm)
        if algorithm in LSTM_ALGORITHMS:
            assert min(launches) > 0, (algorithm, launches)
        else:
            assert launches == (0, 0), (algorithm, launches)
        total = [a + b for a, b in zip(total, launches)]
        print("phase 18: wgan_grid %s: accuracies %s, %s; LSTM kernel "
              "launches %s (forward, backward); wall %.3f s" % (
                  " ".join(argv), accs, lines[-5], launches, wall))

    argv = grid_argv(device, "-t", "1", "2", "-a", "iwgan", "--percents",
                     "0.5")
    (lines, wall), launches = lstm_driven(lambda: run_cli(wgan_grid.main,
                                                          argv))
    assert launches == (0, 0), launches
    assert count(lines, "Train objects per material:", True) == 3, lines[:5]
    assert count(lines, "Test accuracy:", True) == 12 // 5 + 12 // 2 + 12
    loo = [l for l in lines if "_obj" in l and "Test accuracy:" in l]
    assert len(loo) == 72, len(loo)
    assert count(lines, "Average leave-one-object-out accuracy:") == 1
    print("phase 18: wgan_grid %s: %d lines, %d object folds and 72 "
          "leave-one-object-out folds; %s; wall %.3f s" % (
              " ".join(argv), len(lines), 12 // 5 + 12 // 2 + 12,
              lines[-2], wall))

    lumini = OUT_DIR / "lumini"
    argv = ["-t", "0", "-a", "nn", "--dataset", "lumini", "--synthetic",
            "--lumini-dir", str(lumini), "--device", device]
    (lines, wall), launches = lstm_driven(lambda: run_cli(wgan_grid.main,
                                                          argv))
    points = 5 * 5  # exposures x deriv/log transforms
    check_grid_t0(lines, "nn", points)
    assert launches == (0, 0), launches
    print("phase 18: wgan_grid %s: %d grid points x 6 folds; %s; wall %.3f s"
          % (" ".join(argv), points, lines[-3], wall))
    return tuple(total)



# -- this slice: the reference's remaining research paths --------------------

AE_REFERENCE = ROOT / "artifacts" / "ae_gan_ref.jsonl"
GRID_REFERENCE = ROOT / "artifacts" / "grid_svm_rf_ref.jsonl"
AE_EPOCHS, AE_GAN_EPOCHS = 10, 100   # the record's depths (AE 10 of 100)
LEARNED_BAR = CHANCE_ERROR - LEARNED_MARGIN
MAPS_ATOL = 1e-4                     # the card's maps vs the CPU's
PREP_RTOL = 1e-5                     # of each array's range, as in
                                     # tests/test_torch_resample.py:55
RF_MEAN_DELTA = 0.05


def slice_driven(fn):
    """fn() with both kernels' counts set to 0 just before and read just
    after: (result, DFT kernel launches, (LSTM forward, backward))."""
    (result, (fwd, bwd)), dft, _ = driven(lambda: lstm_driven(fn))
    return result, dft, (fwd, bwd)


def ae_reference():
    """The JAX package's recorded AE-GAN cells (tools/record_ae_gan_ref.py):
    {seed: fold errors}, at the depths this phase runs."""
    recs = [json.loads(l) for l in AE_REFERENCE.read_text().splitlines()
            if l.strip()]
    recs = [r for r in recs if r["cell"]["ae_epochs"] == AE_EPOCHS
            and r["cell"]["gan_epochs"] == AE_GAN_EPOCHS]
    assert {r["seed"] for r in recs} >= {0, 1, 2, 3}, recs
    return {r["seed"]: np.asarray(r["result"]) for r in recs}


def recorded_ae_steps(fn, watch_from):
    """fn() with every ``autoencoder.ae_train_step`` recorded as device
    tensors (no sync), each (F,) a step: "mse" the step's reconstruction
    MSE, "zero" its rows' mean square (the MSE of an AE that outputs 0: the
    rows are standardized). From step ``watch_from`` on also "untrained",
    the MSE of the first step's (glorot) parameters on the same rows, and
    "alive", each encoder unit's largest output under the new parameters
    (F, units). Returns (result, record)."""
    rec = {"mse": [], "zero": [], "untrained": [], "alive": None}
    step = autoencoder.ae_train_step

    def recorded(state, xb, cfg):
        if not rec["mse"]:
            rec["init"] = state["params"]  # the step makes new tensors
        state, loss = step(state, xb, cfg)
        rec["mse"].append(loss)
        rec["zero"].append(torch.square(xb).mean(dim=(-2, -1)))
        if len(rec["mse"]) > watch_from:
            with torch.no_grad():
                p0 = rec["init"]
                rec["untrained"].append(torch.square(autoencoder.decode(
                    p0, autoencoder.encode(p0, xb)) - xb).mean(dim=(-2, -1)))
                top = autoencoder.encode(state["params"], xb).amax(dim=-2)
                rec["alive"] = top if rec["alive"] is None else \
                    torch.maximum(rec["alive"], top)
        return state, loss

    autoencoder.ae_train_step = recorded
    try:
        return fn(), rec
    finally:
        autoencoder.ae_train_step = step


def ae_moved(rec, epochs, nb):
    """The cell's autoencoder trained on the card: epochs x nb steps, and on
    the last epoch's rows every fold's reconstruction MSE below its glorot
    draw's on the same rows. The reference's AE learns nothing of the raw
    waveform at these settings: its MSE settles at the zero predictor's in
    the first epoch, below the untrained AE's by that AE's output power,
    and many encoder units die (``tools/ae_trajectory.py``; PERF.md, phase
    19's control). An AE whose update is dropped, or that diverges, fails
    this; the cell's error bars cannot tell an untrained AE."""
    assert len(rec["mse"]) == epochs * nb, (len(rec["mse"]), epochs, nb)
    mse, zero = (torch.stack(rec[k]).cpu().numpy() for k in ("mse", "zero"))
    untrained = torch.stack(rec["untrained"]).cpu().numpy().mean(axis=0)
    last, last_zero = mse[-nb:].mean(axis=0), zero[-nb:].mean(axis=0)
    dead = (rec["alive"] <= 0).sum(dim=-1).cpu().numpy()
    print("phase 19: AE reconstruction MSE a fold: epoch 1 mean %s; epoch %d "
          "mean %s, on the same rows the zero predictor's %s and the "
          "untrained AE's %s; encoder units dead over epoch %d %s of %d" % (
              np.round(mse[:nb].mean(axis=0), 4).tolist(), epochs,
              np.round(last, 4).tolist(), np.round(last_zero, 4).tolist(),
              np.round(untrained, 4).tolist(), epochs, dead.tolist(),
              rec["alive"].shape[-1]))
    assert (last < untrained).all(), (last, untrained)


def ae_gan_phase(dev, pokes=100):
    """Phase 19: the AE-GAN cell at full width (raw modality 3, 7,200 x
    9,600, 6 folds stacked, 100 % labels, seed 0, AE 10 of 100 epochs, GAN
    100 epochs) held to the JAX package's recorded seeds as one more draw
    of them (:func:`seed_distribution`), every fold below chance; against
    the seed-0 record at the DP-parity bars, or the seed-0 / seed-1 spread
    where that is wider, the verdict is printed (the two recorded seeds
    differ by that bar on a fold: a third draw fails it about half the
    time); the cell's AE trained (:func:`ae_moved`). Then the AE step and
    the GAN-on-encodings step timed and profiled, and the CLI at
    SMOKE_POKES pokes an object. Returns the cell's (errors, wall
    seconds)."""
    x3, y3 = ae_cli.raw_contact_dataset(0, pokes)
    assert x3.shape == (72 * pokes, AUDIO_LEN), x3.shape
    ref = ae_reference()
    fold_spread, mean_spread = seed_spread(ref)
    ae_cfg = autoencoder.AeConfig(epochs=AE_EPOCHS)
    gan_cfg = gan.GanConfig(epochs=AE_GAN_EPOCHS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    n_train = len(y3) - len(y3) // 6
    bs, nb = autoencoder.ae_batches(n_train, ae_cfg)
    (errs, dft, lstm_n), ae_rec = recorded_ae_steps(
        lambda: slice_driven(lambda: autoencoder.run_ae_gan_cell(
            x3, y3, 100, ae_cfg=ae_cfg, gan_cfg=gan_cfg, seed=0,
            device=dev)), (AE_EPOCHS - 1) * nb)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    assert dft == 0 and lstm_n == (0, 0), (dft, lstm_n)
    ae_moved(ae_rec, AE_EPOCHS, nb)
    del ae_rec
    two_seed_verdict(
        "phase 19: AE-GAN raw modality 3 (%d x %d), 100 %% labels, AE %d "
        "epochs, GAN %d epochs, seed 0 vs %s seed 0 (its seed-0 / seed-1 "
        "spread: worst fold %.4f, mean %.2f points)" % (
            len(y3), AUDIO_LEN, AE_EPOCHS, AE_GAN_EPOCHS,
            AE_REFERENCE.relative_to(ROOT), fold_spread, 100 * mean_spread),
        errs, ref[0], max(FOLD_DELTA, fold_spread),
        max(MEAN_DELTA, mean_spread))
    seed_distribution("phase 19 AE-GAN", errs, ref)
    # the record itself sits above the 0.733 bar (0.1 below chance), so a
    # faithful port cannot meet it: it is printed, and the cell is held
    # below chance, where every recorded fold is
    record_max = max(e.max() for e in ref.values())
    print("phase 19: every fold below chance (%.4f): port max %.4f, record "
          "max %.4f; the 0.1-below-chance bar (%.4f) is %s by the port and "
          "%s by the record (reported, not held)" % (
              CHANCE_ERROR, errs.max(), record_max, LEARNED_BAR,
              "met" if errs.max() < LEARNED_BAR else "missed",
              "met" if record_max < LEARNED_BAR else "missed"))
    assert errs.max() < CHANCE_ERROR and record_max < CHANCE_ERROR, errs
    ae_updates = 6 * AE_EPOCHS * nb
    gan_updates = 6 * AE_GAN_EPOCHS * (n_train // gan_cfg.batch_size)
    print("phase 19: cell wall %.3f s for %d AE updates (6 folds x %d epochs "
          "x %d batches of %d) and %d GAN updates (6 folds x %d epochs x %d "
          "batches): %.1f updates/s; peak device memory %.3f GB" % (
              wall, ae_updates, AE_EPOCHS, nb, bs, gan_updates,
              AE_GAN_EPOCHS, n_train // gan_cfg.batch_size,
              (ae_updates + gan_updates) / wall, peak / 1e9))

    # the AE step at full width: 6 folds of seeded rows
    gen = torch.Generator(device=dev).manual_seed(0)
    pool = torch.randn((6, n_train, AUDIO_LEN), generator=gen, device=dev)
    state = autoencoder.ae_init_state(gen, AUDIO_LEN, ae_cfg, 6)
    perm = autoencoder.ae_draw_epoch(gen, 6, n_train, ae_cfg)
    rows = torch.arange(6, device=dev)[:, None]

    def ae_step(b):
        nonlocal state
        xb = pool[rows, perm[:, b % nb]]
        state, _ = autoencoder.ae_train_step(state, xb, ae_cfg)

    ae_ms, ae_busy, ae_per_step, ae_ops = time_steps(ae_step)
    n_params = sum(p.numel() for p in tree.leaves(state["params"]))
    print("phase 19: AE step (6 folds, batch %d, D=%d, %d parameters a "
          "fold): median %.4f ms of 60 (CUDA events); device time %s per "
          "step (torch.profiler): device busy %.1f%% of the step; %.1f "
          "device operations per step" % (
              bs, AUDIO_LEN, n_params // 6, ae_ms, fmt_ms(ae_busy),
              100 * ae_busy / ae_ms, ae_per_step))
    print_top_ops("phase 19 AE", ae_ops, 8)
    del pool, state

    # the GAN on the encodings: 6 folds of 256-wide seeded rows
    width = ae_cfg.nodes[-1]
    data = {"x_labeled": torch.randn((6, n_train, width), generator=gen,
                                     device=dev),
            "y_labeled": torch.randint(0, 6, (6, n_train), generator=gen,
                                       device=dev),
            "pool": torch.randn((6, n_train, width), generator=gen,
                                device=dev)}
    gstate = gan.init_state(gan.init_params(gen, width, gan_cfg, 6), gan_cfg)
    li, ui, u2i = gan.epoch_schedule(gen, 6, n_train, n_train, n_train,
                                     gan_cfg.batch_size)
    gnb = li.shape[1]

    def gan_step(b):
        nonlocal gstate
        rand = gan.draw_step(gen, 6, gan_cfg.batch_size, width, gan_cfg)
        gstate, _ = gan.train_step(gstate, data, li[:, b % gnb],
                                   ui[:, b % gnb], u2i[:, b % gnb], rand,
                                   cfg=gan_cfg)

    gan_ms, gan_busy, gan_per_step, gan_ops = time_steps(gan_step)
    print("phase 19: GAN-on-encodings step (6 folds, batch %d, D=%d): "
          "median %.4f ms of 60 (CUDA events); device time %s per step "
          "(torch.profiler): device busy %.1f%% of the step; %.1f device "
          "operations per step" % (
              gan_cfg.batch_size, width, gan_ms, fmt_ms(gan_busy),
              100 * gan_busy / gan_ms, gan_per_step))
    print_top_ops("phase 19 GAN", gan_ops, 8)
    full_ae = 100 * nb * ae_ms / 1e3
    print("phase 19: the reference's 100-epoch AE cell predicted at %.1f s "
          "(%d AE steps at the median, %.1f s; the GAN's %d steps at the "
          "median, %.1f s); not run (no record at that depth)" % (
              full_ae + gan_updates / 6 * gan_ms / 1e3, 100 * nb, full_ae,
              gan_updates // 6, gan_updates / 6 * gan_ms / 1e3))

    argv = ["-t", "1", "--synthetic", "--synthetic-pokes", str(SMOKE_POKES),
            "--epochs", "1", "--percents", "4", "100", "--seed", "0"]
    (lines, cli_wall), dft, lstm_n = slice_driven(
        lambda: run_cli(ae_cli.main, argv))
    assert dft == 0 and lstm_n == (0, 0), (dft, lstm_n)
    assert lines[1] == "-" * 25 + " Testing various amounts of labeled " \
        "training data " + "-" * 25, lines[:3]
    assert count(lines, "Contact mic modality") == 1
    assert count(lines, "Percentage of training data labeled:") == 2
    accs = [float(l.split()[-1]) for l in lines
            if l.startswith("Test accuracy:")]
    assert len(accs) == 12 and all(0 <= a <= 1 for a in accs), lines
    assert count(lines, "Average accuracy:", True) == 2
    print("phase 19: autoencoder main %s: %d lines, 2 x 6 folds, averages "
          "%s; wall %.3f s" % (" ".join(argv), len(lines),
                               [l.split()[-1] for l in lines
                                if l.startswith("Average")], cli_wall))
    return errs, wall


def planted_features(dev, seed=0):
    """tests/test_variants.py:116-155 on the card: a sigmoid MLP trained on
    class-dependent values planted at features y+2..y+4; the maps of 50
    rows put more weight on the planted features. Returns the two means."""
    rng = np.random.RandomState(seed)
    n, k, d = 3000, 5, 10
    y = rng.randint(0, k, n)
    x = rng.rand(n, d).astype(np.float32)
    for i, yy in enumerate(y):
        x[i, yy + 2 : yy + 5] = (0.1, 0.2, 0.3)
    y1h = np.eye(k, dtype=np.float32)[y]
    widths = (64, 64)
    params = nets.mlp_init(rng_util.make_generator(seed, dev), d, k, 1,
                           widths, device=dev)
    opt = optim.init(params)
    xt, yt = (torch.from_numpy(a).to(dev)[None] for a in (x, y1h))
    for _ in range(30):
        perm = rng.permutation(n)
        for s in range(0, n, 128):
            sl = torch.from_numpy(perm[s : s + 128]).to(dev)
            p = tree.tree_map(lambda a: a.detach().requires_grad_(), params)
            loss = torch.square(torch.sigmoid(nets.mlp_apply(
                p, xt[:, sl], widths=widths)) - yt[:, sl]).mean()
            grads = torch.autograd.grad(loss, tree.leaves(p))
            params, opt = optim.update(tree.unflatten(p, grads), opt, params,
                                       lr=1e-3, b1=0.9)

    def fwd(p, xi):
        return torch.sigmoid(nets.mlp_apply(p, xi[None, None],
                                            widths=widths)[0, 0])

    cams = activation_maps.saliency(fwd, params, xt[0, :50],
                                    yt[0, :50]).cpu().numpy()
    mask = np.zeros((50, d), bool)
    for i in range(50):
        mask[i, y[i] + 2 : y[i] + 5] = True
    return cams[mask].mean(), cams[~mask].mean()


def activation_phase(dev, pokes=100, epochs=10):
    """Phase 20: the activation-map CLI at full width (modality 2, 7,200 x
    1,200 -> 1,280, fold 0 of seed 0, the MLP at 10 epochs, 8 samples): the
    .npy maps against the port's CPU maps from the same parameters; the
    planted-feature check on the card."""
    out_dir = OUT_DIR / "activation_maps"
    argv = ["-m", "2", "--synthetic", "--synthetic-pokes", str(pokes),
            "--epochs", str(epochs), "--samples", "8", "--seed", "0",
            "--out-dir", str(out_dir)]
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        res, dft, lstm_n = slice_driven(lambda: am_cli.make_maps(argv))
    wall = time.perf_counter() - t0
    assert dft == 0 and lstm_n == (0, 0), (dft, lstm_n)
    maps = np.load(out_dir / "activation_maps.npy")
    inputs = np.load(out_dir / "activation_inputs.npy")
    assert maps.shape == inputs.shape == (8, 3 * FT_LEN), maps.shape
    assert res["x"].shape == (8, VARIANT_T), res["x"].shape
    params = tree.tree_map(lambda a: a.cpu(), res["params"])
    cpu = activation_maps.mlp_saliency(params, res["x"].cpu(),
                                       res["y_target"].cpu())
    cpu = cpu[:, : res["valid_dim"]].numpy()
    err = float(np.abs(maps - cpu).max())
    assert err <= MAPS_ATOL, err
    assert np.isfinite(maps).all() and maps.min() >= 0 and maps.max() <= 1
    planted, other = planted_features(dev)
    assert planted > other, (planted, other)
    print("phase 20: activation_map main %s: test error %.4f, maps %s (the "
          "PNG %s); card vs CPU maps from the same parameters max_abs_err "
          "%r (bar %g); planted features: mean map %.4f vs %.4f elsewhere; "
          "wall %.3f s" % (
              " ".join(argv), res["error"], maps.shape,
              "written" if len(res["paths"]) == 3 else "skipped: no "
              "matplotlib", err, MAPS_ATOL, planted, other, wall))


def function_api_phase(dev, pokes=100, epochs=10):
    """Phase 21: ``protocol.mr_gan`` on phase 6's modality-5 set, built
    again through the mel kernel: the internal split's test rows (200 a
    class), the error below chance less 0.1, then the trainTestSets route.
    Returns the path's DFT kernel launches."""
    (x, y), dft, lstm_n = slice_driven(lambda: mreo.load_features(
        modalities=5, synthetic_seed=0,
        synthetic_kwargs={"pokes_per_object": pokes}, device=dev))
    assert dft == (72 if dev.type == "cuda" else 0) and lstm_n == (0, 0), (
        dft, lstm_n)
    x, y = x.cpu().numpy(), y.cpu().numpy()
    seen, orig = [], protocol.run_gan_cell

    def record(*a, splits=None, **k):
        seen.append(splits)
        return orig(*a, splits=splits, **k)

    protocol.run_gan_cell = record
    try:
        t0 = time.perf_counter()
        err = protocol.mr_gan(x, y, epochs=epochs, seed=0, device=dev)
        wall = time.perf_counter() - t0
        (tr, te), = seen[0]
        tr_sets = (x[tr], x[te], y[tr], y[te])
        t0 = time.perf_counter()
        err_sets = protocol.mr_gan(x, y, trainTestSets=tr_sets,
                                   epochs=epochs, seed=0, device=dev)
        wall_sets = time.perf_counter() - t0
    finally:
        protocol.run_gan_cell = orig
    assert np.bincount(y[te], minlength=6).tolist() == [200] * 6
    assert len(tr) == len(y) - 1200 and not np.isin(te, tr).any()
    assert err < LEARNED_BAR and err_sets < LEARNED_BAR, (
        err, err_sets)
    print("phase 21: mr_gan modality 5 (%d x %d), 50 %% labels, %d epochs, "
          "seed 0: test rows a class %s, error %.4f (bar %.4f), wall %.3f s; "
          "trainTestSets route: error %.4f, wall %.3f s; %d kernel launches "
          "in the loader" % (*x.shape, epochs, np.bincount(y[te]).tolist(),
                             err,
                             LEARNED_BAR, wall, err_sets, wall_sets,
                             dft))
    return dft


def grid_reference():
    """tools/record_grid_svm_rf_ref.py's lines: {argv tuple: record}."""
    return {tuple(r["argv"]): r for r in
            (json.loads(l) for l in GRID_REFERENCE.read_text().splitlines()
             if l.strip())}


@contextlib.contextmanager
def baseline_timings():
    """Sum the Gram, SMO and forest-fit seconds of every fold the grid CLI
    runs (baselines.learn_svm / learn_rf, wrapped)."""
    total = {"gram_s": 0.0, "solve_s": 0.0, "fit_s": 0.0, "svm": 0, "rf": 0}
    learn_svm, learn_rf = baselines.learn_svm, baselines.learn_rf

    def add(name, timings):
        total[name] += 1
        for k, v in timings.items():
            total[k] += v

    def svm_(*a, **k):
        timings = {}
        acc = learn_svm(*a, timings=timings, **k)
        add("svm", timings)
        return acc

    def rf_(*a, **k):
        timings = {}
        acc = learn_rf(*a, timings=timings, **k)
        add("rf", timings)
        return acc

    baselines.learn_svm, baselines.learn_rf = svm_, rf_
    try:
        yield total
    finally:
        baselines.learn_svm, baselines.learn_rf = learn_svm, learn_rf


def grid_svm_rf_phase(dev):
    """Phase 22: wgan_grid -a svm / -a rf on the card's default (native)
    routes at SMOKE_POKES pokes an object, held to the JAX CLI's record
    (scikit-learn on the CPU): the same lines; the SVM within 0.03 a fold
    (a leave-one-object-out fold holds 10 rows: there, within one row); the
    forest's mean within 0.05 and every fold above chance + 0.1."""
    ref = grid_reference()
    for args in (["-t", "0", "-a", "svm"], ["-t", "0", "-a", "rf"],
                 ["-t", "1", "2", "-a", "svm", "--percents", "0.5"]):
        argv = args + ["--synthetic", "--synthetic-pokes", str(SMOKE_POKES)]
        want = ref[tuple(argv)]
        with baseline_timings() as spent:
            (lines, wall), dft, lstm_n = slice_driven(
                lambda: run_cli(wgan_grid.main, argv))
        assert dft == 0 and lstm_n == (0, 0), (dft, lstm_n)
        assert lines[-1].startswith("Total time:"), lines[-1]
        number = re.compile(r"(?<![\w.])-?\d+(\.\d+)?(e[-+]?\d+)?(?![\w.])")
        assert [number.sub("#", l) for l in lines[:-1]] == [
            number.sub("#", l) for l in want["lines"]], (lines, want)
        accs = np.asarray([float(l.split("Test accuracy:")[1]) for l in lines
                           if "Test accuracy:" in l])
        refs = np.asarray(want["accuracies"])
        delta = np.abs(accs - refs)
        if "rf" in args:
            chance = 1.0 / 6 + LEARNED_MARGIN
            assert abs(accs.mean() - refs.mean()) <= RF_MEAN_DELTA
            assert accs.min() > chance, accs
            verdict = ("mean %.4f vs %.4f (bar %.2f), worst fold %.4f (bar "
                       "> %.4f), folds equal to the record: %s" % (
                           accs.mean(), refs.mean(), RF_MEAN_DELTA,
                           accs.min(), chance, bool((delta == 0).all())))
            times = "forest fits on the host %.3f s (%d folds)" % (
                spent["fit_s"], spent["rf"])
        else:
            loo = np.asarray(["_obj" in l for l in lines
                              if "Test accuracy:" in l])
            bar = np.where(loo, 0.1 + 1e-9, SVM_FOLD_DELTA)
            assert (delta <= bar).all(), (delta, bar)
            verdict = ("worst |delta| %.4f over %d folds (bar %.2f; %d "
                       "leave-one-object-out folds of 10 rows, bar one row: "
                       "%d differ by one)" % (
                           delta.max(), len(delta), SVM_FOLD_DELTA,
                           loo.sum(), int(((delta > 0) & loo).sum())))
            times = ("linear Grams on the card %.3f s, SMO on the host %.3f "
                     "s (%d folds, host copies included)" % (
                         spent["gram_s"], spent["solve_s"], spent["svm"]))
        print("phase 22: wgan_grid %s: %d lines as the JAX CLI's; %s; %s; "
              "wall %.3f s" % (" ".join(argv), len(lines), verdict, times,
                               wall))
    n_lab = 355   # a leave-one-object-out fold's labeled rows: 710 / 2
    a = torch.randn((n_lab, 3 * FT_LEN), device=dev)
    gram_ms = cuda_ms(lambda: svm.linear_kernel(a, a))
    print("phase 22: one linear Gram of %d labeled rows x %d features: "
          "%.4f ms on the card (CUDA events)" % (n_lab, 3 * FT_LEN, gram_ms))


def preprocess_phase(dev):
    """Phase 23: generate_raw_file pickles (6 materials x 2 objects x 4
    pokes, python-2 shaped) through ``cli.preprocess.main`` on the card
    (configs 0 and 7), every array held to a device="cpu" run within 1e-5
    of its range, the output read back through ``mreo.load_features``."""
    raw = OUT_DIR / "data_raw"
    raw.mkdir(parents=True, exist_ok=True)
    for m, material in enumerate(MATERIALS):
        for o in range(2):
            py2pickle.dump_py2(
                synthetic.generate_raw_file(seed=10 * m + o,
                                            material=material, pokes=4),
                str(raw / ("newdata_%s_obj%d_4seqs.pkl" % (material, o))))
    out_card, out_cpu = OUT_DIR / "processed_cuda", OUT_DIR / "processed_cpu"
    argv = ["--raw-dir", str(raw), "--out-dir", str(out_card), "--configs",
            "0", "7", "--prefix", ""]
    (lines, wall), dft, lstm_n = slice_driven(
        lambda: run_cli(prep_cli.main, argv))
    assert dft == 0 and lstm_n == (0, 0), (dft, lstm_n)
    assert count(lines, "Processing:", True) == 2 * 12, lines[:4]
    configs = [preprocess.CONFIGS[0], preprocess.CONFIGS[7]]
    t0 = time.perf_counter()
    preprocess.run(str(raw), str(out_cpu), configs=configs, prefix="",
                   verbose=False, device="cpu")
    wall_cpu = time.perf_counter() - t0
    worst, n_arrays = 0.0, 0
    for ft, c in configs:
        for material in MATERIALS:
            name = Path(mreo.processed_path("", material, ft, c)).name
            got = pickle.loads((out_card / name).read_bytes())
            want = pickle.loads((out_cpu / name).read_bytes())
            assert sorted(got) == sorted(want) and len(got) == 2, got.keys()
            for obj in want:
                for k in want[obj]:
                    g, w = np.asarray(got[obj][k]), np.asarray(want[obj][k])
                    assert g.shape == w.shape and g.dtype == np.float64
                    scale = max(float(np.ptp(w)), 1.0)
                    err = float(np.abs(g - w).max()) / scale
                    assert err <= PREP_RTOL, (name, obj, k, err)
                    worst, n_arrays = max(worst, err), n_arrays + 1
    shapes = []
    for ft, c in configs:
        x, y = mreo.load_features(modalities=2, forcetemp_time=ft,
                                  contactmic_time=c, data_dir=str(out_card),
                                  device=dev)
        assert x.shape == (48, 3 * int(100 * ft)) and torch.isfinite(x).all()
        assert torch.bincount(y).tolist() == [8] * 6
        shapes.append(tuple(x.shape))
    print("phase 23: preprocess main %s: 2 configs x 6 materials x 2 files "
          "of 4 pokes; %d arrays, card vs CPU worst |delta| / range %.3g "
          "(bar %g); load_features modality 2 shapes %s; wall %.3f s on the "
          "card, %.3f s on the CPU" % (" ".join(argv), n_arrays, worst,
                                       PREP_RTOL, shapes, wall, wall_cpu))


# -- this slice: precision "high" and the live collection entry point -------

@contextlib.contextmanager
def mel_precision(name):
    """MRGAN_MEL_PRECISION set to ``name`` inside the block, as a user sets
    it; restored after."""
    old = os.environ.get("MRGAN_MEL_PRECISION")
    os.environ["MRGAN_MEL_PRECISION"] = name
    try:
        yield
    finally:
        if old is None:
            del os.environ["MRGAN_MEL_PRECISION"]
        else:
            os.environ["MRGAN_MEL_PRECISION"] = old


def high_counts():
    return mel_cuda.launches, mel_cuda.high_launches, mel_cuda.reduce_launches


def high_variants(dev, windows, sms):
    """Phase 24a: every (tile, groups) variant at precision "high", held to
    the plain bf16x3 version of the kernel's function (the rows' centring,
    on rounded centres, written out) at the mel power bars, twice, bitwise
    equal; log-mel
    within 0.02 dB of the plain bf16x3 version without it. Returns (variants
    checked, the largest log-mel dB error)."""
    checked, worst_db = 0, 0.0
    for n, audio_len in VARIANT_SHAPES:
        padded, tn, frames = framed_input(dev, windows, n, audio_len)
        f = n * tn
        center = mel_cuda.row_centers(padded, "high").repeat_interleave(tn)
        want = mel_cuda.mel_power_reference(frames, precision="high",
                                            center=center)
        plain = mel_cuda.mel_power_reference(frames, precision="high")
        plain_db = mel.db_scale(plain.reshape(n, tn, 128))
        truth = mel_power_f64(frames)
        for layout in mel_cuda.variants(f, sms):
            before = high_counts()
            run = lambda: mel_cuda._launch(  # noqa: E731
                padded, padded.shape[1], tn, HOP, f, 48000, N_FFT, 128,
                precision="high", layout=layout)
            got, again = run(), run()
            torch.cuda.synchronize()
            assert tuple(a - b for a, b in zip(high_counts(), before)) == (
                0, 2, 2 * (layout[1] > 1)), layout
            name = "high F=%d %s" % (f, mel_cuda.describe(layout, f))
            err = check_close(name, got, want, POWER_RTOL, POWER_ATOL)
            assert torch.equal(got, again), name + ": repeat launch differs"
            db_err = check_close(name + " log-mel", mel.db_scale(
                got.reshape(n, tn, 128)), plain_db, 0, DB_ATOL)
            worst_db = max(worst_db, db_err)
            rel = [((x.double() - truth).abs() / truth.abs().clamp(
                min=1e-30)).max().item() for x in (got, plain)]
            print("variant %s%s: max_abs_err=%r (rtol %g, atol %g) vs the "
                  "centred plain bf16x3, repeat bitwise equal; log-mel vs "
                  "plain bf16x3 %r dB (atol %g); max rel err vs float64: "
                  "kernel %r, plain bf16x3 %r" % (
                      name, " [picked]" if layout == mel_cuda._layout(f, sms)
                      else "", err, POWER_RTOL, POWER_ATOL, db_err, DB_ATOL,
                      rel[0], rel[1]))
            checked += 1
    return checked, worst_db


def high_golden(dev):
    """Phase 24b: the golden librosa-0.5.1 fixtures through frontend_logmel
    under MRGAN_MEL_PRECISION=high, one HIGH launch each, within 0.1 dB."""
    worst = 0.0
    names = sorted(p.name[3:-4] for p in FIXDIR.glob("in_*.npy"))
    assert len(names) >= 6, names
    with mel_precision("high"):
        for name in names:
            x = torch.from_numpy(np.load(FIXDIR / ("in_%s.npy" % name))[None]
                                 .astype(np.float32)).to(dev)
            want = torch.from_numpy(np.load(FIXDIR / ("logmel_%s.npy" % name))
                                    .astype(np.float32)).to(dev)
            before = high_counts()
            got = mel.frontend_logmel(x, flatten=False)[0]
            after = high_counts()
            assert (after[0] - before[0], after[1] - before[1]) == (0, 1), (
                "fixture did not take the HIGH kernel")
            worst = max(worst, check_close("high golden " + name, got, want,
                                           0, HIGH_DB_ATOL))
    print("phase 24: golden fixtures x%d via frontend_logmel under "
          "MRGAN_MEL_PRECISION=high: max_abs_err_db=%r (atol %g dB; the JAX "
          "package reports ~1.5e-3 dB on the TPU)"
          % (len(names), worst, HIGH_DB_ATOL))
    return worst


def high_training_set(dev, x_highest, pokes=100):
    """Phase 24c: load_features at modality 5 under MRGAN_MEL_PRECISION=high,
    counted: 72 HIGH launches, none at "highest"; the log-mel columns within
    0.1 dB of phase 6's HIGHEST build. Returns the HIGH launches."""
    t0 = time.perf_counter()
    with mel_precision("high"):
        (x, y), highest, high, _ = driven_high(lambda: mreo.load_features(
            modalities=5, synthetic_seed=0,
            synthetic_kwargs={"pokes_per_object": pokes}, device=dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_obj = len(MATERIALS) * 12
    assert (highest, high) == (0, n_obj), (highest, high)
    assert x.shape == x_highest.shape and torch.isfinite(x).all()
    n_trace = 3 * FT_LEN
    torch.testing.assert_close(x[:, :n_trace], x_highest[:, :n_trace],
                               rtol=0, atol=0)
    err = check_close("load_features high vs highest", x[:, n_trace:],
                      x_highest[:, n_trace:], 0, HIGH_DB_ATOL)
    print("phase 24: load_features modality 5 under MRGAN_MEL_PRECISION=high:"
          " X %s, %d HIGH kernel launches (%d at highest), wall %.3f s; "
          "log-mel block vs phase 6's HIGHEST build max_abs_err_db=%r "
          "(atol %g dB)" % (tuple(x.shape), high, highest, wall, err,
                            HIGH_DB_ATOL))
    return high


def driven_high(fn):
    """fn() with the kernel counts set to 0 just before and read just after:
    (result, highest launches, high launches, bin-group sums)."""
    mel_cuda.launches = mel_cuda.high_launches = mel_cuda.reduce_launches = 0
    result = fn()
    return (result,) + high_counts()


def high_algorithm_bound(frames):
    """The kernel's method at "high": its DFT as three bf16 GEMM passes at
    the bf16 dense peak plus the dense projection at the TF32 peak (ms)."""
    n_bins = N_FFT // 2 + 1
    return 1e3 * (3 * 2 * 2 * N_FFT * n_bins * frames / BF16_PEAK
                  + 2 * n_bins * 128 * frames / TF32_PEAK)


# (windows, samples each) timed in phase 24: F = 19, 114, 1,368, 48,128
HIGH_TIME_SHAPES = ((1, AUDIO_LEN), (6, AUDIO_LEN), (72, AUDIO_LEN),
                    (512, 48000))


def high_times(dev, shapes=HIGH_TIME_SHAPES):
    """Phase 24d: CUDA-event times at ``shapes``, in turns: the HIGH kernel,
    the HIGHEST kernel, the plain bf16x3 path, the cuFFT route. Returns {F:
    (high, highest, plain, cuFFT ms)} and the bounds."""
    timing, bounds = {}, {}
    for n, audio_len in shapes:
        audio = torch.from_numpy(np.random.RandomState(2).randn(
            n, audio_len).astype(np.float32) * 100).to(dev)
        t = mel.num_frames(audio_len, HOP)
        padded = mel.reflect_pad(audio, N_FFT).contiguous()
        frames = padded.unfold(-1, N_FFT, HOP).reshape(-1, N_FFT)
        fns = (lambda: mel_cuda.mel_power_framed(padded, t, HOP,
                                                 precision="high"),
               lambda: mel_cuda.mel_power_framed(padded, t, HOP),
               lambda: mel_cuda.mel_power_reference(frames, precision="high"),
               lambda: stft_mel_power(audio))
        runs = [[] for _ in fns]
        for order in (range(4), reversed(range(4))):  # in turns
            for i in order:
                runs[i].append(cuda_ms(fns[i]))
        f = n * t
        timing[f] = tuple(statistics.median(r) for r in runs)
        bounds[f] = mel_bound(n, padded.shape[1], f) + (
            high_algorithm_bound(f),)
        ms, bound = timing[f], bounds[f]
        print("phase 24 times F=%d: HIGH kernel %.4f ms, HIGHEST kernel "
              "%.4f ms, plain bf16x3 %.4f ms, cuFFT route %.4f ms (runs %s); "
              "bound %.4f ms (%s: HIGH kernel at %.2f%%), algorithm bound "
              "(DFT as 3 bf16 GEMM passes) %.4f ms (HIGH kernel at %.1f%%), "
              "3xTF32 %.4f ms" % (
                  f, *ms, [["%.4f" % v for v in r] for r in runs], bound[0],
                  bound[1], 100 * bound[0] / ms[0], bound[3],
                  100 * bound[3] / ms[0], bound[2]))
    return timing, bounds


class PokeTimer:
    """Wraps MaterialClassifier.classify_raw_poke and predict_logits while
    installed: CUDA-event milliseconds of each classify_raw_poke call, and
    the logits of each prediction."""

    def __init__(self):
        self.ms, self.logits = [], []

    @contextlib.contextmanager
    def installed(self):
        classify, logits = (MaterialClassifier.classify_raw_poke,
                            MaterialClassifier.predict_logits)
        timer = self

        def timed(clf, raw, index=-1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            name = classify(clf, raw, index)
            end.record()
            end.synchronize()
            timer.ms.append(start.elapsed_time(end))
            return name

        def kept(clf, x):
            out = logits(clf, x)
            timer.logits.append(out.detach().clone())
            return out

        MaterialClassifier.classify_raw_poke = timed
        MaterialClassifier.predict_logits = kept
        try:
            yield self
        finally:
            MaterialClassifier.classify_raw_poke = classify
            MaterialClassifier.predict_logits = logits


def collect_phase(dev, ckpt, seqs=6, timescale=20):
    """Phase 25: the live collection entry point on the card, classifying
    every poke with phase 9's checkpoint; the saved pokes classified again
    offline, and under MRGAN_MEL_PRECISION=high. Returns the (highest, high)
    kernel launches of the driven paths."""
    out = OUT_DIR / "collect"
    if out.exists():
        for old in out.glob("*.pkl"):
            old.unlink()
    argv = ["-n", "metal_block", "-s", str(seqs), "--material", "metal",
            "--timescale", str(timescale), "--no-camera", "--data-dir",
            str(out), "--classifier", ckpt, "--device", "cuda"]
    live = PokeTimer()
    t0 = time.perf_counter()
    with live.installed():
        (lines, wall), highest, high, _ = driven_high(
            lambda: run_cli(collect_cli.main, argv))
    print("\n".join(lines))
    assert not count(lines, "classification failed"), lines
    predicted = [l for l in lines if "predicted material:" in l]
    assert len(predicted) == seqs, predicted
    assert (highest, high) == (seqs, 0), (highest, high)
    assert len(live.ms) == len(live.logits) == seqs
    files = sorted(out.glob("newdata_metal_block_%dseqs*.pkl" % seqs))
    assert len(files) == 1, files
    with open(files[0], "rb") as f:
        raw = pickle.load(f)
    assert len(raw["collisionTime"]) == seqs

    clf = MaterialClassifier.load(ckpt, device=dev)
    offline, high_run = PokeTimer(), PokeTimer()
    with offline.installed():
        names = [clf.classify_raw_poke(raw, index=i) for i in range(seqs)]
    with high_run.installed(), mel_precision("high"):
        (high_names, h_highest, h_high, _) = driven_high(
            lambda: [clf.classify_raw_poke(raw, index=i)
                     for i in range(seqs)])
    assert (h_highest, h_high) == (0, seqs), (h_highest, h_high)
    want = [l.rsplit(": ", 1)[1] for l in predicted]
    assert names == want, (names, want)
    lip = lipschitz(clf.disc)
    gaps, bounds, db_gaps = [], [], []
    for i in range(seqs):
        torch.testing.assert_close(offline.logits[i], live.logits[i],
                                   rtol=0, atol=ROUNDING_ATOL)
        # the HIGH poke's features differ from the HIGHEST one's in the
        # log-mel columns only: its logits move by at most the Lipschitz
        # bound of that gap
        feats = [poke_features(clf, raw, i, p) for p in ("highest", "high")]
        n_trace = 3 * FT_LEN
        db_gaps.append((feats[1][:, n_trace:] - feats[0][:, n_trace:])
                       .abs().max().item())
        d_scaled = (clf._prep(feats[1]) - clf._prep(feats[0])).norm(dim=-1)
        bounds.append((lip * d_scaled + ROUNDING_ATOL).item())
        gaps.append((high_run.logits[i] - offline.logits[i]).abs().max()
                    .item())
        assert torch.isfinite(high_run.logits[i]).all()
    assert max(db_gaps) <= HIGH_DB_ATOL, db_gaps
    assert all(g <= b for g, b in zip(gaps, bounds)), (gaps, bounds)
    print("phase 25: cli.collect.main %s: %d pokes, a prediction each %s, "
          "%d DFT kernel launches (one a poke), wall %.3f s (phase %.3f s); "
          "per-poke classify_raw_poke %s ms (CUDA events; median %.4f ms; "
          "offline, with the collection stack stopped, median %.4f ms, at "
          "high %.4f ms); offline re-classification of the saved pickle: the "
          "same names, logits max_abs_err=%r (atol %g); under "
          "MRGAN_MEL_PRECISION=high: %d HIGH launches, names %s (%s), "
          "log-mel gap %r dB (atol %g), logits gap %s <= bound %s" % (
              " ".join(argv), seqs, want, highest, wall,
              time.perf_counter() - t0, ["%.4f" % m for m in live.ms],
              statistics.median(live.ms), statistics.median(offline.ms),
              statistics.median(high_run.ms),
              max((a - b).abs().max().item() for a, b in zip(
                  offline.logits, live.logits)), ROUNDING_ATOL, h_high,
              high_names, "equal" if high_names == names else "differ",
              max(db_gaps), HIGH_DB_ATOL, ["%.3g" % g for g in gaps],
              ["%.3g" % b for b in bounds]))
    return highest, h_high


def poke_features(clf, raw, i, precision):
    """Poke i's modality-5 features as classify_raw_poke builds them, at the
    given mel precision (not counted: the counts are read already)."""
    keys = ("collisionTime", "RGripRFingerTime", "RGripRFingerForce",
            "temperatureTime", "temperatureRaw", "contactmicTime",
            "contactmic")
    w = preprocess.process_sequences(
        {k: [raw[k][i]] for k in keys}, clf.ft_time, clf.c_time,
        streams={"force", "temperature", "contact"}, device=clf.device)
    with mel_precision(precision):
        return features.assemble(5, **{
            k: clf._tensor(np.asarray(w[k], np.float32))
            for k in ("temperature", "force0", "force1", "contact")})


def high_phase(dev, windows, sms, x_highest):
    """Phase 24. Returns (the HIGH launches of the driven path, the largest
    log-mel dB error against the plain bf16x3 version, times, bounds)."""
    checked, db_err = high_variants(dev, windows, sms)
    print("phase 24: %d kernel variants checked at precision high" % checked)
    high_golden(dev)
    launches = high_training_set(dev, x_highest)
    timing, bounds = high_times(dev)
    return launches, db_err, timing, bounds


# -- phases 26-28: the bf16 shadows and the multi-rank paths -----------------

MULTI_WORLD = 2          # ranks sharing the one card (gloo)
DP_EPOCHS = 5            # phase 27(b)'s depth: 10 put the script at 1,020 s
                         # (PERF.md, PR 9), above the 1,000 s aimed at
DP_CHECK_UPDATES = 10
# the first update's bars (tests/test_parallel.py:133, :166); later
# updates are printed, and the cell held: float32 reduction order grows to
# the losses' first digit within 10 updates at the flagship width (Adam's
# normalisation turns a rounding difference of a near-zero gradient into
# up to lr a step), on one process as across ranks
DP_CHECK_ATOL = {"float32": 3e-4, "bfloat16": 3e-3}
DP_LOSS_ATOL = 1e-5
TP_ATOL = 1e-5
RANK_TIMEOUT_S = 900


def shadow_step(ds):
    """Phase 26's recorded step (``matmul_weight_dtype="bfloat16"``): every
    forward's weights the bf16 round of the masters, bit for bit, and the
    weight gradients bf16."""
    cfg = gan.GanConfig(matmul_weight_dtype="bfloat16")
    lab, pool, train, test = fold_tensors(ds, 100)
    data = gan.scale_folds(ds.X, ds.y, lab, pool, train, test)
    generator = rng_util.make_generator(0, ds.X.device)
    state = gan.init_state(gan.init_params(generator, ds.X.shape[1], cfg, 6),
                           cfg)
    li, ui, u2i = gan.epoch_schedule(generator, 6, lab.shape[1],
                                     pool.shape[1], train.shape[1],
                                     cfg.batch_size)
    rand = gan.draw_step(generator, 6, cfg.batch_size, ds.X.shape[1], cfg)
    seen, grads = [], []
    real_dense, real_update = nets.dense, optim.update

    def dense(p, x):
        seen.append(p["w"])
        return real_dense(p, x)

    def update(g, *a, **k):
        grads.append(g)
        return real_update(g, *a, **k)

    nets.dense, optim.update = dense, update
    try:
        new, _ = gan.train_step(state, data, li[:, 0], ui[:, 0], u2i[:, 0],
                                rand, cfg=cfg)
    finally:
        nets.dense, optim.update = real_dense, real_update
    gen_w = [state["gen"][k]["w"] for k in ("d1", "d2", "d3")]
    disc_order = ["d0", "d1", "d2", "d3", "mid", "out"]
    want = (gen_w + [state["disc"][k]["w"] for k in disc_order] + gen_w
            + [new["disc"][k]["w"] for k in disc_order])
    assert len(seen) == len(want) == 18, len(seen)
    exact = all(s.dtype == torch.bfloat16 and torch.equal(s, w.bfloat16())
                for s, w in zip(seen, want))
    assert exact, "a forward read other weights than the masters' bf16 round"
    grad_w = [leaf for g in grads
              for path, leaf in zip(tree_paths(g), tree.leaves(g))
              if path[-1] == "w"]
    assert len(grads) == 2 and len(grad_w) == 9
    assert all(g.dtype == torch.bfloat16 for g in grad_w)
    print("phase 26: recorded step: 18 forward weight reads, each the bf16 "
          "round of its master bit for bit (gen d1-d3, disc d0-out, gen, the "
          "updated disc); %d weight gradients, all bfloat16" % len(grad_w))


def shadow_role(rank, world, init, data_path, arg):
    """Phase 26's cell, in a process of its own beside phase 27's ranks:
    phase 8's cell with bf16 weight shadows. ``arg``: (device, epochs)."""
    device, epochs = arg
    ds = _dataset(data_path, torch.device(device))
    t0 = time.perf_counter()
    errs = protocol.run_gan_cell(
        ds, percentlabeled=100, cfg=gan.GanConfig(
            matmul_weight_dtype="bfloat16", epochs=epochs), seed=0)
    return {"errors": errs, "wall": time.perf_counter() - t0}


def shadow_cell_check(out, f32_errs, epochs=100):
    """Phase 26's cell held to phase 8's float32 cell at the DP-parity
    bars, and printed beside the JAX record (made with shadows)."""
    errs = np.asarray(out["errors"])
    hold_to_reference(
        "phase 26: shadows, modality 5, 100 %% labels, %d epochs, seed 0 vs "
        "phase 8's float32 cell (wall %.3f s, in its own process beside "
        "phase 27's ranks)" % (epochs, out["wall"]), errs, f32_errs,
        FOLD_DELTA, MEAN_DELTA, "float32")
    want_jax = reference_errors()
    print("phase 26: beside the JAX record (its default, bf16 shadows): "
          "worst |delta| %.4f, |mean delta| %.2f points" % (
              np.abs(errs - want_jax).max(),
              100 * abs((errs - want_jax).mean())))


def _rank_main(role, rank, world, init, out_path, data_path, arg):
    """A spawned rank of phase 27 or 28 (gloo or NCCL): runs ``role`` and
    pickles ("ok", result) or ("error", traceback) to ``out_path``."""
    import traceback

    import torch.distributed as dist

    torch.set_num_threads(2)
    try:
        numeric.set_fp32_policy()
        result = _ROLES[role](rank, world, init, data_path, arg)
        status = ("ok", result)
    except BaseException:  # noqa: BLE001 — reported to the parent
        status = ("error", traceback.format_exc())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(status, f)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _dataset(data_path, dev):
    arrays = np.load(data_path)
    return protocol.DeviceDataset(torch.from_numpy(arrays["x"]).to(dev),
                                  torch.from_numpy(arrays["y"]).to(dev),
                                  device=dev)


def _gloo(rank, world, init, device):
    from mrgan_tpu_torch.parallel import multihost

    multihost.initialize(init_method=init, world_size=world, rank=rank,
                         backend="gloo")
    return torch.device(device)


def collectives_on_cuda(dev):
    """All-reduce SUM and MAX and all-gather of CUDA tensors under gloo."""
    import torch.distributed as dist

    r, n = dist.get_rank(), dist.get_world_size()
    a = torch.full((4,), float(r + 1), device=dev)
    dist.all_reduce(a)
    b = torch.full((4,), float(r + 1), device=dev)
    dist.all_reduce(b, op=dist.ReduceOp.MAX)
    got = [torch.empty(2, device=dev) for _ in range(n)]
    dist.all_gather(got, torch.full((2,), float(r), device=dev))
    assert a.device == b.device == got[0].device == dev
    assert a.tolist() == [n * (n + 1) / 2] * 4 and b.tolist() == [float(n)] * 4
    assert [g.tolist() for g in got] == [[float(i)] * 2 for i in range(n)]
    return "all-reduce SUM, all-reduce MAX, all-gather of %s tensors" % dev


def sweep_role(rank, world, init, data_path, arg):
    """Phase 27(a): the phase-8 cell through the sweep route, folds 3 + 3,
    at ``epochs``; then 27(c) and 27(d). ``arg``: (device, epochs)."""
    from mrgan_tpu_torch.parallel import mesh as mesh_lib

    device, epochs = arg
    dev = _gloo(rank, world, init, device)
    out = {"collectives": collectives_on_cuda(dev)}
    ds = _dataset(data_path, dev)
    mesh = mesh_lib.make_mesh(device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    out["errors"] = protocol.run_gan_cell(
        ds, percentlabeled=100, cfg=gan.GanConfig(epochs=epochs), seed=0,
        mesh=mesh)
    out["wall"] = time.perf_counter() - t0
    out["logmel"] = sharded_logmel_rank(dev)
    out["tp"] = tp_rank(dev)
    return out


def _state_gap(a, b):
    """The largest |a - b| over each part of two training states."""
    gap = {}
    for k in ("gen", "disc", "opt_d", "opt_g"):
        pick = (lambda st: st[k]) if k in ("gen", "disc") else (
            lambda st: {"m": st[k]["m"], "v": st[k]["v"]})
        gap[k] = max((x.float() - y.float()).abs().max().item()
                     for x, y in zip(tree.leaves(pick(a)), tree.leaves(pick(b))))
    return gap


def dp_role(rank, world, init, data_path, arg):
    """Phase 27(b): updates fed one process's draws against one process, in
    both weight regimes (the state after the first update and after
    DP_CHECK_UPDATES, and every update's losses); then the cell at
    ``epochs`` through the DP route (25 rows a rank). ``arg``: (device,
    epochs)."""
    from mrgan_tpu_torch.parallel import mesh as mesh_lib
    from mrgan_tpu_torch.parallel import spmd

    device, epochs = arg
    dev = _gloo(rank, world, init, device)
    ds = _dataset(data_path, dev)
    mesh = mesh_lib.make_mesh(n_cell=1, n_data=world, device=dev)
    out = {"updates": {}}
    lab, pool, train, test = fold_tensors(ds, 100)
    data = gan.scale_folds(ds.X, ds.y, lab, pool, train, test)
    rr = torch.arange(6, device=dev)[:, None]
    for wd in ("float32", "bfloat16"):
        cfg = gan.GanConfig(matmul_weight_dtype=wd)
        generator = rng_util.make_generator(0, dev)
        params = gan.init_params(generator, ds.X.shape[1], cfg, 6)
        li, ui, u2i = gan.epoch_schedule(generator, 6, lab.shape[1],
                                         pool.shape[1], train.shape[1],
                                         cfg.batch_size)
        rows = gan.local_rows(cfg.batch_size, mesh.data_group)
        single = dp = gan.init_state(params, cfg)
        loss_gaps, gaps = [], []
        t0 = time.perf_counter()
        for b in range(DP_CHECK_UPDATES):
            rand = gan.draw_step(generator, 6, cfg.batch_size, ds.X.shape[1],
                                 cfg)
            single, want = gan.train_step(single, data, li[:, b], ui[:, b],
                                          u2i[:, b], rand, cfg=cfg)
            local = gan.local_draws(rand, slice(None), rows, cfg.batch_size)
            dp, got = spmd.dp_batch_step(
                dp, data["x_labeled"][rr, li[:, b, rows]],
                data["y_labeled"][rr, li[:, b, rows]],
                data["pool"][rr, ui[:, b, rows]],
                data["pool"][rr, u2i[:, b, rows]], local, cfg=cfg,
                group=mesh.data_group)
            loss_gaps.append(max((g - w).abs().max().item()
                                 for g, w in zip(got, want)))
            if b in (0, DP_CHECK_UPDATES - 1):
                gaps.append(_state_gap(single, dp))
        _sync(dev)
        out["updates"][wd] = (gaps, loss_gaps, time.perf_counter() - t0)
    _sync(dev)
    t0 = time.perf_counter()
    out["errors"] = protocol.run_gan_cell(
        ds, percentlabeled=100, cfg=gan.GanConfig(epochs=epochs), seed=0,
        mesh=mesh)
    out["wall"] = time.perf_counter() - t0
    return out


def sharded_audio():
    """Phase 27(c)'s inputs: phase 3's 72-window request, zero-padded from
    9,600 to 9,728 samples (19 frames do not split in 2; 20 do), and the
    512 x 1 s block (94 frames)."""
    request = request_windows(72, seed=0)["contact"]
    request = np.pad(request, ((0, 0), (0, 9728 - AUDIO_LEN)))
    block = (np.random.RandomState(2).randn(512, 48000) * 100).astype(
        np.float32)
    return {"request 72 x 9,728": request, "block 512 x 48,000": block}


def sharded_logmel_rank(dev):
    """Phase 27(c) on a rank: ``logmel_sharded`` over the data axis of a
    (1, 2) mesh; its blocks and the mel kernel's launches."""
    from mrgan_tpu_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.make_mesh(n_cell=1, n_data=MULTI_WORLD, device=dev)
    out = {}
    for name, audio in sharded_audio().items():
        mel_cuda.launches = 0
        block = mel.logmel_sharded(torch.from_numpy(audio).to(dev), mesh)
        out[name] = (block.cpu().numpy(), mel_cuda.launches)
    return out


def tp_rank(dev):
    """Phase 27(d) on a rank: the TP block at the discriminator's first
    pair (3,632 -> 1,000 -> 500) against the dense pair."""
    from mrgan_tpu_torch.parallel import tensor

    g = torch.Generator().manual_seed(3)
    w1 = nets.glorot_uniform(g, (3632, 1000)).to(dev)
    w2 = nets.glorot_uniform(g, (1000, 500)).to(dev)
    b1 = (0.1 * torch.randn(1000, generator=g)).to(dev)
    b2 = (0.1 * torch.randn(500, generator=g)).to(dev)
    x = torch.randn(150, 3632, generator=g).to(dev)
    shards, b2_rep = tensor.shard_dense_pair(w1, b1, w2, b2, MULTI_WORLD)
    got = tensor.make_tp_mlp_block()(shards, b2_rep, x)
    want = torch.relu(x @ w1 + b1) @ w2 + b2
    return (got - want).abs().max().item()


def nccl_role(rank, world, init, data_path, arg):
    """Phase 28: NCCL at world size 1: the sweep and DP entry points return
    the single process's cell bit for bit (1 epoch); then a second rank of
    a world of 2 is refused its card (cuda:1)."""
    import torch.distributed as dist

    from mrgan_tpu_torch.parallel import mesh as mesh_lib
    from mrgan_tpu_torch.parallel import multihost, spmd, sweep

    assert multihost.initialize(init_method=init, world_size=1, rank=0,
                                backend="nccl", local_rank=0)
    dev = multihost.local_device()
    ds = _dataset(data_path, dev)
    mesh = mesh_lib.make_mesh(device=dev)
    assert dist.get_backend() == "nccl" and mesh.shape == {"cell": 1,
                                                           "data": 1}
    idx = [t.cpu().numpy() for t in fold_tensors(ds, 100)]
    cfg = gan.GanConfig(epochs=1)

    def run(fn, **kw):
        return fn(rng_util.make_generator(0, dev), ds.X, ds.y, *idx,
                  valid_dim=ds.valid_dim, cfg=cfg, **kw)

    out = {"single": run(gan.train_folds_indexed),
           "sweep": run(sweep.train_gan_work_indexed, mesh=mesh),
           "dp": run(spmd.train_gan_cell_dp, mesh=mesh)}
    dist.destroy_process_group()
    try:
        multihost.initialize(init_method=init + "-2", world_size=2, rank=1,
                             backend="nccl", local_rank=1)
        out["second_rank"] = None
    except RuntimeError as e:
        out["second_rank"] = str(e)
    return out


def shared_card_role(rank, world, init, data_path, arg):
    """Phase 28: two NCCL ranks both on cuda:0: the first collective must
    raise (NCCL takes one card a rank), never run on gloo."""
    import torch.distributed as dist

    from mrgan_tpu_torch.parallel import multihost

    multihost.initialize(init_method=init, world_size=world, rank=rank,
                         backend="nccl", local_rank=0, timeout_s=60)
    assert dist.get_backend() == "nccl"
    t = torch.ones(4, device="cuda:0")
    try:
        dist.all_reduce(t)
        _sync(dev)
    except Exception as e:  # noqa: BLE001 — the expected refusal
        return "raised %s: %s" % (type(e).__name__, str(e).splitlines()[0])
    return None


_ROLES = {"sweep": sweep_role, "dp": dp_role, "nccl": nccl_role,
          "shared_card": shared_card_role, "shadow": shadow_role}


def start_ranks(role, world, data_path, arg=None, tag=None):
    """Spawn ``world`` ranks of ``role`` (a file store under OUT_DIR for
    the rendezvous); returns a handle for :func:`join_ranks`."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    tag = tag or role
    store = OUT_DIR / ("store_" + tag)
    for p in (store, Path(str(store) + "-2")):
        if p.exists():
            p.unlink()
    outs = [OUT_DIR / ("%s_rank%d.pkl" % (tag, r)) for r in range(world)]
    for o in outs:
        if o.exists():
            o.unlink()
    procs = [ctx.Process(target=_rank_main, args=(
        role, r, world, "file://%s" % store, str(o), str(data_path), arg))
        for r, o in enumerate(outs)]
    for p in procs:
        p.start()
    return procs, outs, time.perf_counter()


def join_ranks(handle, timeout=RANK_TIMEOUT_S, allow_hang=False):
    """Every rank's result, or raise with the first failing rank's
    traceback; a rank still running at the timeout is killed."""
    procs, outs, t0 = handle
    hung = []
    for r, p in enumerate(procs):
        p.join(max(1.0, timeout - (time.perf_counter() - t0)))
        if p.is_alive():
            p.kill()
            p.join()
            hung.append(r)
    if hung and not allow_hang:
        raise RuntimeError("ranks %s still running after %d s" % (hung,
                                                                   timeout))
    results = []
    for r, o in enumerate(outs):
        if r in hung:
            results.append("hung: killed after %d s" % timeout)
            continue
        with open(o, "rb") as f:
            status, value = pickle.load(f)
        if status != "ok":
            raise RuntimeError("rank %d failed:\n%s" % (r, value))
        results.append(value)
    return results, time.perf_counter() - t0


def same_bits_np(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a.view(np.uint8),
                                                 b.view(np.uint8))


def sweep_checks(dev, sweep_out, f32_errs, sweep_epochs=100):
    """Phases 27(a), (c) and (d) from the sweep ranks' results. Returns the
    mel kernel's launches of 27(c) (both ranks)."""
    for r, out in enumerate(sweep_out):
        print("phase 27: rank %d: %s" % (r, out["collectives"]))
    errs = np.asarray(sweep_out[0]["errors"])
    assert same_bits_np(errs, sweep_out[1]["errors"]), "ranks disagree"
    hold_to_reference(
        "phase 27(a): sweep, 2 gloo ranks on the card (folds 3 + 3), %d "
        "epochs, seed 0 vs phase 8's single-process cell (wall %.3f s)"
        % (sweep_epochs, sweep_out[0]["wall"]), errs, f32_errs, FOLD_DELTA,
        MEAN_DELTA, "one process")
    print("phase 27(a): bit for bit phase 8's: %s; largest fold difference "
          "%r" % (same_bits_np(errs, f32_errs),
                  float(np.abs(errs - f32_errs).max())))
    launches = 0
    for name, audio in sharded_audio().items():
        want = mel.frontend_logmel(torch.from_numpy(audio).to(dev),
                                   flatten=False)
        got = np.concatenate([out["logmel"][name][0] for out in sweep_out],
                             axis=-1)
        counts = [out["logmel"][name][1] for out in sweep_out]
        err = float(np.abs(got - want.cpu().numpy()).max())
        print("phase 27(c): logmel_sharded %s over 2 ranks: %s -> blocks of "
              "%d frames, max_abs_err_db vs frontend_logmel %r (bar %g); mel "
              "kernel launches per rank %s" % (
                  name, tuple(audio.shape), got.shape[-1] // 2, err, DB_ATOL,
                  counts))
        assert got.shape == tuple(want.shape) and err <= DB_ATOL, err
        assert all(c == int(dev.type == "cuda") for c in counts), counts
        launches += sum(counts)
    tp = [out["tp"] for out in sweep_out]
    print("phase 27(d): TP block 3,632 -> 1,000 -> 500 over 2 ranks vs the "
          "dense pair: max_abs_err %s (bar %g)" % (tp, TP_ATOL))
    assert max(tp) <= TP_ATOL, tp
    return launches


LAYOUTS = ((6,), (3, 3), (2, 2, 2), (4, 2))  # launches of one process


def one_process_layouts(ds, epochs, layouts=LAYOUTS):
    """Phase 8's cell at ``epochs`` on one process, its folds trained in
    each of ``layouts`` (launches of so many folds, each on its draws of
    the launch of 6): float32 rounding is all that differs, the spread a
    correct data-parallel cell sits in at a depth where the cell has not
    converged. Returns {layout: (6,) errors}."""
    rng = np.random.RandomState(0)
    splits = protocol.stratified_splits(ds.y_host, 6, seed=0)
    idx = [np.stack(a) for a in zip(*(
        protocol.fold_indices(ds.y_host, tr, te, 100, None, 6, rng)
        for tr, te in splits))]
    seed = rng.randint(2**31 - 1)
    cfg = gan.GanConfig(epochs=epochs)
    out = {}
    for layout in layouts:
        starts = np.cumsum((0,) + layout)
        out[layout] = np.concatenate([gan.train_folds_indexed(
            rng_util.make_generator(seed, ds.X.device), ds.X, ds.y, *idx,
            valid_dim=ds.valid_dim, cfg=cfg, folds=slice(s, e))
            for s, e in zip(starts[:-1], starts[1:])])
    return out


def dp_checks(dp_out, layouts, dp_epochs=DP_EPOCHS):
    """Phase 27(b) from the data-parallel ranks' results: the first update
    at the JAX test's bars; the cell as one more draw of one process's
    layouts at the same depth, with the DP-parity verdict against the
    one-launch run printed."""
    for wd, atol in DP_CHECK_ATOL.items():
        for r, out in enumerate(dp_out):
            (first, last), loss_gaps, wall = out["updates"][wd]
            print("phase 27(b): rank %d, %s weights, updates on 25 rows a "
                  "rank fed one process's draws, largest |delta| after 1 / "
                  "%d: gen %.3g / %.3g, disc %.3g / %.3g, Adam disc %.3g / "
                  "%.3g, gen %.3g / %.3g (the first update's bar %g); losses "
                  "of each update %s (the first's bar %g); %.3f s" % (
                      r, wd, DP_CHECK_UPDATES, first["gen"], last["gen"],
                      first["disc"], last["disc"], first["opt_d"],
                      last["opt_d"], first["opt_g"], last["opt_g"], atol,
                      ["%.2g" % v for v in loss_gaps], DP_LOSS_ATOL, wall))
            assert max(first.values()) <= atol, (wd, first)
            assert loss_gaps[0] <= DP_LOSS_ATOL, (wd, loss_gaps)
    dp_errs = np.asarray(dp_out[0]["errors"])
    assert same_bits_np(dp_errs, dp_out[1]["errors"]), "ranks disagree"
    runs = list(layouts.values())
    gap = max(float(np.abs(a - b).max()) for i, a in enumerate(runs)
              for b in runs[i + 1:])
    print("phase 27(b): one process at %d epochs, folds in launches of %s: "
          "%s; the largest fold gap between two layouts %.4f (the DP-parity "
          "fold bar %g)" % (dp_epochs, [list(l) for l in layouts],
                            [np.round(e, 4).tolist() for e in runs], gap,
                            FOLD_DELTA))
    delta = dp_errs - runs[0]
    inside = (np.abs(delta).max() <= FOLD_DELTA
              and abs(delta.mean()) <= MEAN_DELTA)
    print("phase 27(b): data-parallel cell, 2 gloo ranks on the card (25 "
          "rows a rank), %d epochs, seed 0: %s vs one process's one launch "
          "%s: worst |delta| %.4f, |mean delta| %.2f points: %s the "
          "DP-parity bars (printed; held below as one more layout) (wall "
          "%.3f s, %.3f s an epoch)" % (
              dp_epochs, np.round(dp_errs, 4).tolist(),
              np.round(runs[0], 4).tolist(), np.abs(delta).max(),
              100 * abs(delta.mean()), "inside" if inside else "OUTSIDE",
              dp_out[0]["wall"], dp_out[0]["wall"] / dp_epochs))
    seed_distribution("phase 27(b): the data-parallel cell", dp_errs,
                      layouts, "one process's %d fold layouts")


def tables_rank_main(argv):
    """``python -m torch.distributed.run ... chip_smoke.py --tables-rank
    DIR <cli.tables flags>``: one rank of phase 27(e); runs the table CLI's
    entry point and writes its mel kernel launches to DIR."""
    out_dir = Path(argv[0])
    rank = int(os.environ["RANK"])
    mel_cuda.launches = 0
    tables.main(argv[1:])
    (out_dir / ("rank%d.json" % rank)).write_text(json.dumps(
        {"launches": mel_cuda.launches}))


CLI_ARGV = ["--tables", "1", "--synthetic", "--synthetic-pokes",
            str(SMOKE_POKES), "--epochs", "1", "--seed", "0", "--modalities",
            "5", "--dist-backend", "gloo", "--device", "cuda"]


def shape_of(line):
    return re.sub(r"-?\d+(\.\d+)?(e-?\d+)?", "#", line)


def multi_rank_cli(single_lines):
    """Phase 27(e): the table CLI on 2 gloo ranks under
    torch.distributed.run: rank 0 prints what one process prints (phase
    7's lines, numbers aside), rank 1 nothing, the checkpoint is written
    once. Returns the ranks' mel kernel launches."""
    out_dir = OUT_DIR / "cli_ranks"
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in out_dir.glob("*"):
        old.unlink()
    ckpt = out_dir / "cells.jsonl"
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env["PYTHONPATH"] = str(ROOT)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(MULTI_WORLD), str(ROOT / "chip_smoke.py"),
         "--tables-rank", str(out_dir), *CLI_ARGV, "--checkpoint",
         str(ckpt)], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=600)
    wall = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.splitlines()
    assert [shape_of(l) for l in lines] == [shape_of(l)
                                            for l in single_lines], (
        len(lines), len(single_lines))
    cells = [json.loads(l)["cell"] for l in ckpt.read_text().splitlines()]
    assert len(cells) == 7 == len({json.dumps(c) for c in cells}), cells
    counts = [json.loads((out_dir / ("rank%d.json" % r)).read_text())[
        "launches"] for r in range(MULTI_WORLD)]
    assert counts == [72, 72], counts
    print("phase 27(e): torch.distributed.run --nproc-per-node %d cli.tables "
          "%s: %d lines from rank 0, each in the format of phase 7's single "
          "process (rank 1 prints nothing); checkpoint: %d cells, once; mel "
          "kernel launches per rank %s; wall %.3f s" % (
              MULTI_WORLD, " ".join(CLI_ARGV), len(lines), len(cells), counts,
              wall))
    return sum(counts)


def nccl_phase(data_path):
    """Phase 28: NCCL at world size 1 gives the single process's cell bit
    for bit through the sweep and DP entry points; a second NCCL rank is
    refused a card that does not exist, and two NCCL ranks on the one card
    fail at their first collective, never falling back to gloo."""
    (one,), wall = join_ranks(start_ranks("nccl", 1, data_path), timeout=300)
    for route in ("sweep", "dp"):
        same = same_bits_np(one[route], one["single"])
        print("phase 28: NCCL, world 1: %s entry point %s vs one process %s: "
              "bit for bit %s" % (route, np.round(one[route], 4).tolist(),
                                  np.round(one["single"], 4).tolist(), same))
        assert same, route
    assert one["second_rank"] and "takes cuda:1" in one["second_rank"], one
    print("phase 28: NCCL rank 1 of 2 refused: %s" % one["second_rank"])
    pair, pair_wall = join_ranks(start_ranks("shared_card", 2, data_path),
                                 timeout=180, allow_hang=True)
    print("phase 28: two NCCL ranks on cuda:0: %s (%.1f s)" % (pair,
                                                             pair_wall))
    assert all(str(p).startswith("raised") for p in pair), pair
    return wall + pair_wall


# -- the last paths: the paper figures, the SVM zoo and PCA, the double backward

def plots_phase(dev):
    """Phase 29: the trace figures' data on the card, each material's
    log-mel (one ``mel_power`` launch for all six) held to the plain path;
    the checkpoint curves; the figures where a renderer is installed.
    Returns the ``mel_power`` launches."""
    (traces, t), launches, _ = driven(
        lambda: plots.sample_trace_data(dev, synthetic_seed=0))
    assert launches == 1, launches
    worst = 0.0
    for m, tr in traces.items():
        plain = mel.logmel(torch.from_numpy(tr["contact"][None]).to(dev),
                           flatten=False)[0].cpu()
        worst = max(worst, check_close("phase 29 %s log-mel" % m,
                                       torch.from_numpy(tr["logmel"]),
                                       plain, 0, DB_ATOL))
        assert tr["force"].shape == tr["temperature"].shape == t.shape
    curves = {table: plots.curves_from_checkpoint(
        ROOT / "artifacts" / ("t%d_sweep.jsonl" % table), table)
        for table in (1, 5)}
    for table, c in curves.items():
        assert c, table
        print("phase 29: Table %d curves from artifacts/t%d_sweep.jsonl: %s"
              % (table, table, "; ".join(
                  "%s: %s" % (name, ", ".join("%g %.2f" % xy
                                              for xy in zip(*points)))
                  for name, points in sorted(c.items()))))
    out_dir = OUT_DIR / "plots"
    try:
        (lines, wall), more, _ = driven(lambda: run_cli(plots_cli.main, [
            "--synthetic", "--out-dir", str(out_dir), "--device",
            str(dev)]))
    except ImportError as e:
        assert "plotly or matplotlib" in str(e), e
        drawn = ("neither plotly nor matplotlib is installed here: the "
                 "figures raise %r; they render where one is" % str(e))
    else:
        launches += more
        made = [l.split("Wrote ")[1] for l in lines]
        assert len(made) == 5 and all(os.path.getsize(f) for f in made), made
        drawn = "cli.plots wrote %s in %.3f s" % (
            ", ".join(Path(f).name for f in made), wall)
    print("phase 29: sample_trace_data on the card: 6 log-mel blocks %s "
          "from %d mel_power launch(es), max_abs_err %r dB vs the plain "
          "path (bar %g); %s" % (traces[MATERIALS[0]]["logmel"].shape,
                                 launches, worst, DB_ATOL, drawn))
    return launches


SVM_ZOO_REFERENCE = ROOT / "artifacts" / "svm_zoo_ref.jsonl"
SVM_ZOO_FRACTION = 0.5
PCA_COMPONENTS, PCA_RANGE_TOL, PCA_VAR_RTOL = 100, 1e-4, 1e-4
SVM_KERNELS = ("SVC rbf", "SVC linear", "NuSVC rbf", "NuSVC linear",
               "LinearSVC")


def zoo_fold(x, y, tr, te, dev):
    """One -t 0 fold of the grid's SVM protocol, kernels 0-4 on their
    native routes: (accuracies, timings)."""
    x_tr, x_te = baselines.pca_scale(x[tr], x[te], scale="scale")
    x_lab, y_lab = baselines.select_fraction_labeled(
        x_tr, np.asarray(y[tr], np.int32), SVM_ZOO_FRACTION, 6,
        np.random.RandomState(54321))
    accs, spent = [], []
    for kernel in range(5):
        timings = {}
        accs.append(baselines.learn_svm(x_lab, y_lab, x_te, y[te], kernel,
                                        device=dev, timings=timings))
        spent.append(timings)
    return accs, spent


def svm_zoo_phase(dev, x2, y2):
    """Phase 30: the SVM zoo's five kernels on the grid's -t 0 folds of
    modality 2 against the JAX package's scikit-learn record, and the
    exact PCA on the card against the CPU route and the record's
    spectrum."""
    ref = [json.loads(l) for l in SVM_ZOO_REFERENCE.read_text().splitlines()
           if l.strip()]
    x, y = x2.cpu().numpy(), y2.cpu().numpy()
    folds = list(protocol.stratified_splits(y, n_splits=6, seed=54321))
    assert len(ref) == len(folds) == 6
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(folds)) as pool:
        results, dft, lstm_n = slice_driven(lambda: list(pool.map(
            lambda f: zoo_fold(x, y, *f, dev), folds)))
    wall = time.perf_counter() - t0
    assert dft == 0 and lstm_n == (0, 0), (dft, lstm_n)
    accs = np.asarray([r[0] for r in results])
    want = np.asarray([r["accuracies"] for r in ref])
    delta = np.abs(accs - want)
    assert (delta <= SVM_FOLD_DELTA).all(), (accs, want)
    for k, name in enumerate(SVM_KERNELS):
        gram = sum(r[1][k]["gram_s"] for r in results)
        solve = sum(r[1][k]["solve_s"] for r in results)
        print("phase 30: kernel %d (%s): accuracies %s vs the record's %s, "
              "worst |delta| %.4f (bar %.2f); Grams on the card %.1f ms "
              "(host copy included), %s %.3f s (6 folds summed, the folds "
              "side by side)" % (
                  k, name, ["%.4f" % a for a in accs[:, k]],
                  ["%.4f" % a for a in want[:, k]], delta[:, k].max(),
                  SVM_FOLD_DELTA, 1e3 * gram,
                  "Newton solve on the card" if k == 4 else
                  "SMO on the host", solve))
    print("phase 30: 5 kernels x 6 folds of %d labeled rows in %.3f s, "
          "record %s" % (len(y) * 5 // 12, wall,
                         SVM_ZOO_REFERENCE.relative_to(ROOT)))
    t0 = time.perf_counter()
    worst_out = worst_var = 0.0
    for (tr, te), rec in zip(folds, ref):
        got = baselines.pca_scale(x[tr], x[te], pca=PCA_COMPONENTS,
                                  scale="scale", device=dev)
        cpu = baselines.pca_scale(x[tr], x[te], pca=PCA_COMPONENTS,
                                  scale="scale", device="cpu")
        for g, c in zip(got, cpu):
            err = np.abs(g - c).max() / (c.max() - c.min())
            assert err <= PCA_RANGE_TOL, err
            worst_out = max(worst_out, err)
        var = baselines.pca_fit(x[tr], PCA_COMPONENTS, dev)[2].cpu().numpy()
        rel = np.abs(var / np.asarray(rec["explained_variance"]) - 1).max()
        assert rel <= PCA_VAR_RTOL, rel
        worst_var = max(worst_var, rel)
    print("phase 30: pca_scale(pca=%d, scale) on 6 folds of 6,000 x 1,200: "
          "card vs CPU route max |delta| %.3g of the range (bar %g); "
          "explained variance vs scikit-learn's full SVD in float64 max "
          "rtol %.3g (bar %g); %.3f s with the CPU routes" % (
              PCA_COMPONENTS, worst_out, PCA_RANGE_TOL, worst_var,
              PCA_VAR_RTOL, time.perf_counter() - t0))


def all_counts():
    return (lstm_cuda.fwd_launches, lstm_cuda.bwd_launches,
            lstm_cuda.ext_launches, lstm_cuda.adj_launches)


def all_driven(fn):
    """fn() with the four recurrence kernels' counts set to 0 just before
    and read just after: (result, (fwd, bwd, bwd_ext, adj))."""
    lstm_cuda.fwd_launches = lstm_cuda.bwd_launches = 0
    lstm_cuda.ext_launches = lstm_cuda.adj_launches = 0
    result = fn()
    return result, all_counts()


@contextlib.contextmanager
def plain_recurrence():
    """The port's biLSTM through the plain loop on any device: the route
    the kernels are held to."""
    bilstm = lstm.bilstm
    lstm.bilstm = lambda p, xs, return_sequences=True: lstm.bilstm_reference(
        p, xs, return_sequences)
    try:
        yield
    finally:
        lstm.bilstm = bilstm


def critic_fn(params):
    def fn(m):
        return nets.dense(params["out"], vnets.bilstm_apply(
            params["lstm"], m.unsqueeze(-1), return_sequences=False))
    return fn


def penalty_inputs(dev, folds, rows, seed):
    """Real and fake rows (F, rows, T) with the critic's zero tail, eps."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    xr, xf = (torch.randn((folds, rows, VARIANT_T), generator=gen,
                          device=dev) for _ in range(2))
    xr[..., 3 * FT_LEN:] = xf[..., 3 * FT_LEN:] = 0.0
    return xr, xf, torch.rand((folds, rows, 1), generator=gen, device=dev)


def input_grad_norms(params, xr, xf, eps):
    """Each mixed row's norm of the gradient the penalty hinges."""
    mixed = (eps * xr + (1 - eps) * xf).requires_grad_()
    grad, = torch.autograd.grad(critic_fn(params)(mixed).mean(
        dim=(-2, -1)).sum(), mixed)
    return grad.norm(dim=-1)


def penalty_grads(params, xr, xf, eps):
    """The Petzka penalty (F,) and its gradients w.r.t. every parameter
    (zero for the head's bias, which it does not reach)."""
    p = tree.tree_map(lambda a: a.detach().requires_grad_(), params)
    pen = losses.lipschitz_penalty(critic_fn(p), xr, xf, eps, petzka=True)
    leaves = tree.leaves(p)
    grads = torch.autograd.grad(pen.sum(), leaves, allow_unused=True)
    return pen.detach(), [torch.zeros_like(a) if g is None else g
                          for a, g in zip(leaves, grads)]


def hold_grads(name, got, want, f64):
    """Gradients of the kernels' route against the plain loop's at phase
    16's bars, or, past them, no further from float64 (``f64()``, the plain
    loop in float64) than twice the plain loop is. Returns the worst
    max_abs_err and the notes of the float64 rule."""
    worst, notes, g64 = 0.0, [], None
    for i, (a, b) in enumerate(zip(got, want)):
        err = (a - b).abs().max().item()
        worst = max(worst, err)
        if torch.allclose(a, b, rtol=LSTM_GRAD_RTOL, atol=LSTM_GRAD_ATOL):
            continue
        if g64 is None:
            g64 = f64()
        k64 = (a.double() - g64[i]).abs().max().item()
        p64 = (b.double() - g64[i]).abs().max().item()
        assert k64 <= max(2 * p64, LSTM_GRAD_ATOL), (name, i, err, k64, p64)
        notes.append("leaf %d: %.3g vs plain, %.3g / %.3g from float64"
                     % (i, err, k64, p64))
    return worst, notes


def scaled_head(params, xr, xf, eps, at_least=2.0):
    """``params`` with the head's weights scaled so that every mixed row's
    input-gradient norm is at least ``at_least`` (it is linear in them):
    every row of the penalty active. Returns (params, scale)."""
    with torch.enable_grad():
        norms = input_grad_norms(params, xr, xf, eps)
    scale = at_least / norms.min().item()
    out = {**params["out"], "w": params["out"]["w"] * scale}
    return {**params, "out": out}, scale


def penalty_case(dev, folds, units, rows, seed):
    """31(1)-(2): the penalty's parameter gradients at one biLSTM layer's
    width through the kernels and the plain loop on the card."""
    params, _, _ = lstm_case(dev, folds, 1, units, rows, False, seed)
    xr, xf, eps = penalty_inputs(dev, folds, rows, seed)
    params, scale = scaled_head(params, xr, xf, eps)
    norms = input_grad_norms(params, xr, xf, eps)
    assert (norms > 1).all(), norms.min()
    (pen, got), counts = all_driven(lambda: penalty_grads(params, xr, xf,
                                                          eps))
    assert counts == (1, 0, 2, 1), counts
    with plain_recurrence():
        pen_p, want = penalty_grads(params, xr, xf, eps)
        f64 = lambda: penalty_grads(  # noqa: E731
            tree.tree_map(torch.Tensor.double, params), xr.double(),
            xf.double(), eps.double())[1]
        worst, notes = hold_grads("penalty U=%d" % units, got, want, f64)
    check_close("penalty U=%d" % units, pen, pen_p, LSTM_GRAD_RTOL,
                LSTM_GRAD_ATOL)
    print("phase 31: penalty at %d folds x %d mixed rows, T=%d, U=%d, in 1, "
          "final state (head x %.4g: every row's gradient norm >= %.3f): "
          "penalty %s; kernel launches (fwd, bwd, bwd_ext, adj) %s; "
          "parameter gradients vs the plain loop max_abs_err %r (rtol %g, "
          "atol %g%s)" % (
              folds, rows, VARIANT_T, units, scale, norms.min().item(),
              ["%.4f" % v for v in pen.tolist()], counts, worst,
              LSTM_GRAD_RTOL, LSTM_GRAD_ATOL,
              "; past it: " + ", ".join(notes) if notes else ""))


def timed_once(fn):
    """(fn(), its milliseconds between two CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def second_order_bound(n_seq, steps, rows, units, kernel):
    """The least time of a double-backward kernel's work, as
    :func:`lstm_bound` counts it: the bytes its inputs and outputs must
    move once over HBM's rate against its float32 operations over the
    CUDA cores' peak. lstm_scan_bwd_ext with cotangents: zs, dzs (4U a
    cell), c, dcs in and dz out; lstm_scan_adj: delta, zs (4U), c, e, k in,
    e_bar, zs_bar (4U), c_bar out; a step's sums over wh (2 x 4U x U a
    row) and ~25 (bwd_ext) or ~45 (adj) operations a unit."""
    cells = n_seq * steps * rows
    floats = {"bwd_ext": cells * (4 + 4 + 1 + 1 + 4) * units,
              "adj": cells * (4 + 4 + 3 + 1 + 4 + 1) * units}[kernel]
    floats += n_seq * (units * 4 * units + rows * units)
    flops = cells * (8 * units * units
                     + {"bwd_ext": 25, "adj": 45}[kernel] * units)
    ops_s, bytes_s = flops / FP32_PEAK, 4 * floats / HBM_BYTES_S
    return 1e3 * max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s
                                       else "bytes")


# the earlier, unstaged design's times at the penalty's shape (two runs of
# this script on an NVIDIA H100 80GB HBM3, 700 W), printed beside the
# staged kernels'
SECOND_ORDER_EARLIER_MS = {"bwd_ext": (0.8429, 0.8404),
                           "bwd_ext carries": (0.7860, 0.7834),
                           "adj": (0.9028, 0.9032)}


def second_order_inputs(dev, folds, rows, units, seed):
    """The saved tensors of one forward of the critic's biLSTM layer on the
    card, the carries of one backward and seeded cotangents, by name."""
    n_seq = 2 * folds
    params, x, _ = lstm_case(dev, folds, 1, units, rows, False, seed)
    fwd, _ = lstm_kernel_calls(dev, params, x, units, rows, False)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    with torch.no_grad():
        _, _, zs, c = fwd(None)
        wh = lstm._both(params["lstm"])[1].reshape(n_seq, units, 4 * units)
        dh_last = rand(n_seq, rows, units)
        _, e, k = lstm_cuda.lstm_scan_bwd_ext(None, dh_last, zs, c, wh, 2,
                                              carries=True)
        return dict(zs=zs, c=c, wh=wh, dh_last=dh_last, dzs=rand(*zs.shape),
                    dcs=rand(*c.shape), delta=rand(*zs.shape), e=e, k=k)


# the double backward's three kernel calls: the second backward's (the
# cotangents entering), the recorded first backward's (its carries
# stored), the adjoint's; each through (ext, adj), the wrappers or their
# plain versions
SECOND_ORDER_CALLS = {
    "bwd_ext": lambda i, ext, adj: ext(
        None, i["dh_last"], i["zs"], i["c"], i["wh"], 2, dzs=i["dzs"],
        dcs=i["dcs"])[:1],
    "bwd_ext carries": lambda i, ext, adj: ext(
        None, i["dh_last"], i["zs"], i["c"], i["wh"], 2, carries=True),
    "adj": lambda i, ext, adj: adj(i["delta"], i["zs"], i["c"], i["e"],
                                   i["k"], i["wh"], 2),
}


def second_order_variant(lanes):
    """(ext, adj): the two wrappers forced to ``lanes`` a row."""
    return (lambda *a, **k: lstm_cuda.lstm_scan_bwd_ext(*a, lanes=lanes, **k),
            lambda *a, **k: lstm_cuda.lstm_scan_adj(*a, lanes=lanes, **k))


def second_order_times(dev, folds=6, rows=128, units=4, seed=31,
                       update_rows=384):
    """31(3): the two kernels alone at the penalty's shape, on the tensors
    of one forward and seeded cotangents, every lanes-a-row variant: the
    first held to its plain version at phase 16's gradient bars (or the
    float64 rule), the others to the first bit for bit; each timed with
    CUDA events (20 launches back to back, twice) in turns with the plain
    version (one run each), beside the bound and the unstaged design's
    times.
    lstm_scan_bwd_ext is timed with cotangents entering (the second
    backward's call) and with its carries stored (the recorded first
    backward's). Then every variant again at a critic update's rows
    (``update_rows``), bit for bit alike and timed, without the plain
    versions. Returns the JSON fields of both kernels (the wrapper's pick
    of lanes)."""
    n_seq = 2 * folds
    i32 = second_order_inputs(dev, folds, rows, units, seed)
    i64 = {name: t.double() for name, t in i32.items()}
    plains = (lstm_cuda.bwd_ext_reference, lstm_cuda.adj_reference)
    pick = lstm_cuda.default_lanes(units, n_seq, rows)
    fields = {}
    for name, call in SECOND_ORDER_CALLS.items():
        plain = lambda: call(i32, *plains)  # noqa: E731
        # in turns: plain (the run the kernels are held to), every
        # variant twice, plain
        want, first_ms = timed_once(plain)
        first, err, notes, lanes_ms = None, 0.0, [], {}
        for lanes in lstm_cuda.LANES[units]:
            kernel = lambda: call(i32, *second_order_variant(lanes))  # noqa: E731
            got = kernel()
            if first is None:
                first = got
                err, notes = hold_grads("phase 31 " + name, got, want,
                                        lambda: call(i64, *plains))
            else:
                assert same_bits(tuple(got), tuple(first)), (name, lanes)
            lanes_ms[lanes] = [stream_ms(kernel), stream_ms(kernel)]
        plain_ms = [first_ms, stream_ms(plain, runs=1, warmup=0)]
        bound = second_order_bound(n_seq, VARIANT_T, rows, units,
                                   name.split()[0])
        ms, p_ms = (statistics.median(lanes_ms[pick]),
                    statistics.median(plain_ms))
        print("phase 31: %s at %d sequences x %d rows, T=%d, U=%d, %d lanes "
              "a row (the wrapper's pick): kernel %.4f ms (%.1f ns a step), "
              "plain %.4f ms (runs %s), bound %.4f ms (%s; the kernel at "
              "%.2f %%); the unstaged design %s ms; max_abs_err vs "
              "plain %r%s; every variant (%s bit for bit): %s" % (
                  name, n_seq, rows, VARIANT_T, units, pick, ms,
                  1e6 * ms / VARIANT_T, p_ms,
                  ["%.1f" % v for v in plain_ms], *bound,
                  100 * bound[0] / ms,
                  " / ".join("%.4f" % v
                             for v in SECOND_ORDER_EARLIER_MS[name]), err,
                  " (past the bar: %s)" % ", ".join(notes) if notes else "",
                  "the first held to plain, the others to it",
                  variant_times(lanes_ms, bound[0])))
        if name in ("bwd_ext", "adj"):
            fields["lstm_scan_" + name] = dict(
                max_abs_err=err, ms=ms, plain_ms=p_ms, bound_ms=bound[0],
                bound_by=bound[1], library_ms=None)
    # a critic update's rows: the kernels alone
    i32 = second_order_inputs(dev, folds, update_rows, units, seed + 1)
    lines = []
    for name, call in SECOND_ORDER_CALLS.items():
        first, lanes_ms = None, {}
        for lanes in lstm_cuda.LANES[units]:
            kernel = lambda: call(i32, *second_order_variant(lanes))  # noqa: E731
            got = kernel()
            if first is None:
                first = got
            else:
                assert same_bits(tuple(got), tuple(first)), (name, lanes)
            lanes_ms[lanes] = [stream_ms(kernel), stream_ms(kernel)]
        bound = second_order_bound(n_seq, VARIANT_T, update_rows, units,
                                   name.split()[0])
        lines.append("%s (bound %.4f ms, %s): %s" % (
            name, *bound, variant_times(lanes_ms, bound[0])))
    print("phase 31: at a critic update's %d sequences x %d rows, T=%d, "
          "U=%d, every variant bit for bit the first's (no plain run): %s"
          % (n_seq, update_rows, VARIANT_T, units, "; ".join(lines)))
    return fields


def variant_times(lanes_ms, bound_ms):
    """'lanes: ms (ns a step, share of the bound; runs)' for each variant,
    its ms the median of its runs."""
    out = []
    for lanes, runs in lanes_ms.items():
        ms = statistics.median(runs)
        out.append("%d lanes %.4f ms (%.1f ns a step, %.2f %% of the "
                   "bound; runs %s)" % (
                       lanes, ms, 1e6 * ms / VARIANT_T, 100 * bound_ms / ms,
                       ", ".join("%.4f" % v for v in runs)))
    return ", ".join(out)


@contextlib.contextmanager
def recorded(module, name, record):
    """Wrap ``module.name`` so that each call's arguments and result are
    passed to ``record`` first."""
    fn = getattr(module, name)

    def wrapped(*a, **k):
        out = fn(*a, **k)
        record(a, k, out)
        return out

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, fn)


def petzka_disc_grads(state, xl, yl, xu, r, cfg):
    """The gradients one ``disc_step`` takes (its Adam update skipped)."""
    grads = []

    def keep(grad_tree, opt, params, **kw):
        grads.append(tree.leaves(grad_tree))
        return params, opt

    update = wgan.optim.update
    wgan.optim.update = keep
    try:
        wgan.disc_step(state, xl, yl, xu, r, cfg)
    finally:
        wgan.optim.update = update
    return grads[0]


def petzka_step(dev, x2, y2, folds=6):
    """31(4): one full-width critic update of ``disc_step`` with
    ``petzka_lp=True`` (batch 128 of modality 2's rows, padded to T), the
    head scaled so that the penalty is active on every row: the gradients
    through the kernels against the plain loop's. Returns its launches."""
    cfg = dataclasses.replace(wgan_grid.algorithm_config("iwganlstm", 1),
                              petzka_lp=True)
    bs = cfg.batch_size
    gen = torch.Generator(device=dev).manual_seed(314)
    state = wgan.init_state(wgan.init_params(gen, VARIANT_T, cfg, folds))
    rows = torch.randint(0, len(y2), (3, folds, bs), generator=gen,
                         device=dev)
    x = (x2 - x2.mean(dim=0)) / x2.std(dim=0).clamp(min=1e-6)
    xs = gan.pad_features(x[rows], 128)[0]
    xl, xu, yl = xs[0], xs[1], y2[rows[0]].to(torch.int64)
    r = wgan.draw_step(gen, folds, cfg)["disc"][0]
    with torch.no_grad():
        x_fake = vnets.small_generator_apply(state["gen"], r["z"])
    disc, scale = scaled_head(state["disc"], xu, x_fake, r["eps"])
    state = {**state, "disc": disc}
    got, counts = all_driven(lambda: petzka_disc_grads(state, xl, yl, xu, r,
                                                       cfg))
    assert min(counts) > 0, counts
    with plain_recurrence():
        want = petzka_disc_grads(state, xl, yl, xu, r, cfg)
        dbl = lambda t: tree.tree_map(torch.Tensor.double, t)  # noqa: E731
        r64 = {k: v.double() if torch.is_tensor(v) else v
               for k, v in r.items()}
        f64 = lambda: petzka_disc_grads(  # noqa: E731
            {**state, "disc": dbl(state["disc"]), "gen": dbl(state["gen"])},
            xl.double(), yl, xu.double(), r64, cfg)
        worst, notes = hold_grads("disc_step", got, want, f64)
    print("phase 31: disc_step petzka_lp=True, %d folds x batch %d, T=%d "
          "(head x %.4g: the penalty active on every row): kernel launches "
          "(fwd, bwd, bwd_ext, adj) %s; the critic's gradients vs the plain "
          "loop max_abs_err %r (rtol %g, atol %g%s)" % (
              folds, bs, VARIANT_T, scale, counts, worst, LSTM_GRAD_RTOL,
              LSTM_GRAD_ATOL,
              "; past it: " + ", ".join(notes) if notes else ""))
    return counts


PETZKA_EPOCHS = 2


def petzka_cell(x2, y2, epochs=PETZKA_EPOCHS):
    """31(5): ``run_wgan_cell`` with ``iwganlstm_config(petzka_lp=True)`` at
    full width: its errors, the share of critic updates (each fold's) with
    the penalty active, the step time. No JAX record exists for it: the
    errors are printed, not held. Returns its launches."""
    cfg = dataclasses.replace(wgan_grid.algorithm_config("iwganlstm", epochs),
                              petzka_lp=True)
    active = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recorded(losses, "lipschitz_penalty",
                  lambda a, k, out: active.append(out.detach() > 0)):
        errs, counts = all_driven(lambda: wgan.run_wgan_cell(
            x2, y2, 1.0, cfg=cfg, seed=0, device=x2.device))
    wall = time.perf_counter() - t0
    assert np.isfinite(errs).all() and errs.shape == (6,), errs
    assert min(counts) > 0, counts
    share = torch.stack(active).float().mean().item()
    steps = len(active)
    print("phase 31: run_wgan_cell iwganlstm petzka_lp=True, modality 2, "
          "%d epochs, batch %d, seed 0: errors %s (mean %.4f; no record: "
          "printed, not held); penalty active in %.1f %% of %d x 6 critic "
          "updates; %.3f s, %.2f ms a step; kernel launches (fwd, bwd, "
          "bwd_ext, adj) %s" % (
              epochs, cfg.batch_size, ["%.4f" % e for e in errs],
              errs.mean(), 100 * share, steps, wall, 1e3 * wall / steps,
              counts))
    return counts


def double_backward_phase(dev, x2, y2):
    """Phase 31. Returns (the driven paths' launches (fwd, bwd, bwd_ext,
    adj), the JSON fields of lstm_scan_bwd_ext and lstm_scan_adj)."""
    penalty_case(dev, 6, 4, 128, seed=29)
    penalty_case(dev, 1, 16, 128, seed=30)
    fields = second_order_times(dev)
    launches = [a + b for a, b in zip(petzka_step(dev, x2, y2),
                                      petzka_cell(x2, y2))]
    return launches, fields



def main():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; "
                           "torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    script_t0 = time.perf_counter()
    print(gpu_line())
    print(numeric.set_fp32_policy())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(sys.version.split()[0], "torch", torch.__version__, "cuda",
          torch.version.cuda, "sms", sms)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:  # one nvcc (or g++) a source, side by side
        builds = [pool.submit(m.build) for m in (mel_cuda, lstm_cuda)]
        builds += [pool.submit(serialdev.sim_path, name) for name in SIMS]
        for built in builds:
            built.result()
    print("built %s, %s and the firmware simulators %s in %.3f s" % (
        mel_cuda.library_path().name, lstm_cuda.library_path().name,
        ", ".join(Path(b.result()).name for b in builds[2:]),
        time.perf_counter() - t0))
    for line in (mel_cuda.build_log + lstm_cuda.build_log).splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling")):
            print("  ptxas:", line.strip())

    windows = request_windows(72, seed=0)
    win_dev = on(dev, windows)
    print("%d kernel variants checked" % variants_vs_plain(dev, win_dev, sms))
    db_err = kernel_vs_plain(dev, win_dev, sms)

    # -- the full-width modality-5 classifier --------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    disc = nets.Discriminator(FULL_DIM, len(MATERIALS), generator=gen,
                              device=dev)
    feats = features.assemble(5, **win_dev)
    x, valid_dim = gan.pad_features(feats, 128)
    assert x.shape == (72, FULL_DIM) and valid_dim == 3632, (x.shape,
                                                              valid_dim)
    mean, inv_std = gan.scale_stats(x)
    clf = MaterialClassifier(disc, mean, inv_std, 5, valid_dim=valid_dim,
                             ft_time=FT_TIME, c_time=C_TIME, device=dev)
    path = clf.save(str(OUT_DIR / "clf"))
    served = MaterialClassifier.load(path, device=dev)
    torch.testing.assert_close(served.predict_logits(x[:6]),
                               clf.predict_logits(x[:6]), rtol=0, atol=1e-6)
    print("classifier D=%d valid=%d saved and reloaded from %s"
          % (FULL_DIM, valid_dim, Path(path).relative_to(ROOT)))

    sizes = (1, 6, 72)
    requests = {n: {k: v[:n] for k, v in windows.items()} for n in sizes}
    raw = raw_poke(seed=1)

    def counted(call):
        before = mel_cuda.launches, mel_cuda.reduce_launches
        result = call()
        return result, (mel_cuda.launches - before[0],
                        mel_cuda.reduce_launches - before[1])

    t_req = mel.num_frames(AUDIO_LEN, HOP)
    mel_cuda.launches = mel_cuda.reduce_launches = 0
    per_request = {}
    for n in sizes:
        names, per_request[n] = counted(
            lambda: served.classify_pokes(**requests[n]))
        assert len(names) == n and set(names) <= set(MATERIALS), names
        # one DFT launch, and a bin-group sum where the layout splits bins
        assert per_request[n] == (
            1, int(mel_cuda._layout(n * t_req, sms)[1] > 1)), per_request
    raw_name, per_request["raw"] = counted(
        lambda: served.classify_raw_poke(raw))
    assert raw_name in MATERIALS and per_request["raw"][0] > 0
    launches, reduce_launches = mel_cuda.launches, mel_cuda.reduce_launches
    print("main path: (DFT, bin-group sum) launches per request %s, total "
          "%d and %d; raw poke -> %s" % (per_request, launches,
                                         reduce_launches, raw_name))

    lip = lipschitz(served.disc)
    for n in sizes:
        w = {k: v[:n] for k, v in win_dev.items()}
        f_kernel = features.assemble(5, **w)
        f_plain = features.assemble(5, logmel=mel.logmel(w["contact"]),
                                    **{k: v for k, v in w.items()
                                       if k != "contact"})
        # the log-mel columns were held to float64 in phase 3
        feat_err = (f_kernel - f_plain).abs().max().item()
        d_scaled = (served._prep(f_kernel) - served._prep(f_plain)).norm(
            dim=-1)
        bound = lip * d_scaled + ROUNDING_ATOL
        logits = served.predict_logits(f_kernel)
        plain = served.predict_logits(f_plain)
        assert torch.isfinite(logits).all() and logits.shape == (n, 6)
        gap = (logits - plain).abs().amax(dim=-1)
        assert (gap <= bound).all(), (gap, bound)
        print("request %d: features max_abs_err_db=%r; logits vs plain mel "
              "path max_abs_err=%r <= bound %r (spectral-norm product %.4g "
              "x scaled feature gap + %g)" % (
                  n, feat_err, gap.max().item(), bound.min().item(), lip,
                  ROUNDING_ATOL))

    # -- times -----------------------------------------------------------------
    calls = [("request %d pokes" % n,
              lambda n=n: served.classify_pokes(**requests[n])) for n in sizes]
    calls.append(("raw poke", lambda: served.classify_raw_poke(raw)))
    for name, call in calls:
        ms, busy = cuda_ms(call), device_ms(call)
        print("%s: %.4f ms (median of %d); device busy %s%s" % (
            name, ms, RUNS, fmt_ms(busy),
            "" if busy is None else " (%.1f%% of the request)"
            % (100 * busy / ms)))

    timing, bound = {}, {}
    for n, audio_len in ((1, AUDIO_LEN), (6, AUDIO_LEN), (72, AUDIO_LEN),
                         (512, 48000)):
        audio = torch.from_numpy(np.random.RandomState(2).randn(
            n, audio_len).astype(np.float32) * 100).to(dev)
        t = mel.num_frames(audio_len, HOP)
        padded = mel.reflect_pad(audio, N_FFT).contiguous()
        frames = padded.unfold(-1, N_FFT, HOP).reshape(-1, N_FFT)
        kernel_ms, plain_ms, lib_ms = [], [], []
        for _ in range(2):  # in turns: plain, kernel, kernel, plain
            plain_ms.append(cuda_ms(
                lambda: mel_cuda.mel_power_reference(frames)))
            kernel_ms.append(cuda_ms(
                lambda: mel_cuda.mel_power_framed(padded, t, HOP)))
            lib_ms.append(cuda_ms(lambda: stft_mel_power(audio)))
            kernel_ms.append(cuda_ms(
                lambda: mel_cuda.mel_power_framed(padded, t, HOP)))
            plain_ms.append(cuda_ms(
                lambda: mel_cuda.mel_power_reference(frames)))
        f = n * t
        bound[f] = mel_bound(n, padded.shape[1], f)
        timing[f] = (statistics.median(kernel_ms), statistics.median(plain_ms),
                     statistics.median(lib_ms))
        gflop = 2 * 2 * N_FFT * (N_FFT // 2 + 1) * f / 1e9
        print("mel_power F=%d %s: kernel %.4f ms (%.1f TFLOP/s), plain "
              "%.4f ms, cuFFT route %.4f ms; runs %s / %s / %s; bound %.4f ms "
              "(%s: kernel at %.2f%% of it, cuFFT route at %.2f%%), "
              "algorithm bound (DFT as a 3xTF32 GEMM) %.4f ms (kernel at "
              "%.1f%%)"
              % (f, mel_cuda.describe(mel_cuda._layout(f, sms), f),
                 timing[f][0], gflop / timing[f][0], timing[f][1],
                 timing[f][2], ["%.4f" % v for v in kernel_ms],
                 ["%.4f" % v for v in plain_ms], ["%.4f" % v for v in lib_ms],
                 bound[f][0], bound[f][1], 100 * bound[f][0] / timing[f][0],
                 100 * bound[f][0] / timing[f][2], bound[f][2],
                 100 * bound[f][2] / timing[f][0]))
        print("mel_power F=%d device time: kernel %s (row centers, DFT "
              "kernel, bin-group sum), plain %s, cuFFT route %s" % (
                  f, fmt_ms(device_ms(
                      lambda: mel_cuda.mel_power_framed(padded, t, HOP))),
                  fmt_ms(device_ms(
                      lambda: mel_cuda.mel_power_reference(frames))),
                  fmt_ms(device_ms(lambda: stft_mel_power(audio)))))
    f_main = 72 * mel.num_frames(AUDIO_LEN, HOP)

    # -- the training path -------------------------------------------------------
    phase_t0 = time.perf_counter()
    mel_cuda.launches = mel_cuda.reduce_launches = 0
    x, y, synth, contact = training_set(dev)
    ds = protocol.DeviceDataset(x, y, device=dev)
    t_phase = {"6": time.perf_counter() - phase_t0}
    phase7_lines = entry_point("cuda")
    train_launches = mel_cuda.launches
    t_phase["7"] = time.perf_counter() - phase_t0 - sum(t_phase.values())
    print("training path: %d DFT kernel launches, %d bin-group sums (phases "
          "6 and 7)" % (train_launches, mel_cuda.reduce_launches))
    assert train_launches == 2 * 72, train_launches
    cell = full_cell(ds)
    t_phase["8"] = time.perf_counter() - phase_t0 - sum(t_phase.values())
    (fit_launches, _), clf_path = fitted_classifier(dev, x, y, synth)
    t_phase["9"] = time.perf_counter() - phase_t0 - sum(t_phase.values())
    training_kernel_times(contact)
    step_times(ds, cell)
    t_phase["10"] = time.perf_counter() - phase_t0 - sum(t_phase.values())

    # -- this slice: the tables, the baselines ---------------------------------
    db_err = max(db_err, table5_shapes(dev, sms))
    t_phase["11"] = time.perf_counter() - phase_t0 - sum(t_phase.values())
    table_launches = loo_full_scale(dev)  # the loader's memo still holds
    widest_table5_peak(dev)
    t_phase["12"] = time.perf_counter() - phase_t0 - sum(t_phase.values())
    mlp_phase(ds)
    t_phase["13"] = time.perf_counter() - phase_t0 - sum(t_phase.values())
    table_launches += svm_phase(x, y)
    t_phase["14"] = time.perf_counter() - phase_t0 - sum(t_phase.values())
    table_launches += nn_cli()
    t_phase["15"] = time.perf_counter() - phase_t0 - sum(t_phase.values())

    # -- this slice: the variant zoo -----------------------------------------
    lstm_fields = lstm_kernels_vs_plain(dev)
    t_phase["16"] = time.perf_counter() - phase_t0 - sum(t_phase.values())
    (x2, y2), mel_2, _ = driven(lambda: mreo.load_features(
        modalities=2, synthetic_seed=0,
        synthetic_kwargs={"pokes_per_object": 100}, device=dev))
    assert x2.shape == (7200, 3 * FT_LEN) and mel_2 == 0, (x2.shape, mel_2)
    variant_launches = [0, 0]
    for algorithm in ("iwgan", "iwganlstm"):
        launches_17 = variant_cell(x2, y2, algorithm)[2]
        assert (min(launches_17) > 0) == (algorithm == "iwganlstm")
        step_ms = variant_step_times(dev, algorithm)
        variant_launches = [a + b for a, b in zip(variant_launches,
                                                  launches_17)]
    full_depth_prediction(y2, step_ms)
    t_phase["17"] = time.perf_counter() - phase_t0 - sum(t_phase.values())
    with grid_depth(1):
        grid_launches, mel_18, _ = driven(grid_cli)
    assert mel_18 == 0, mel_18
    variant_launches = [a + b for a, b in zip(variant_launches,
                                              grid_launches)]
    t_phase["18"] = time.perf_counter() - phase_t0 - sum(t_phase.values())

    # -- this slice: the reference's remaining research paths ----------------
    ae_gan_phase(dev)
    t_phase["19"] = time.perf_counter() - phase_t0 - sum(t_phase.values())

    # -- this slice: precision "high", the live collection entry point --------
    # (run before phases 20-23, which share the card with phase 26-27's
    # processes: 24 times the kernel, 25 a poke's latency)
    high_24, high_db_err, high_timing, high_bounds = high_phase(
        dev, win_dev, sms, x)
    t_phase["24"] = time.perf_counter() - phase_t0 - sum(t_phase.values())
    collect_highest, collect_high = collect_phase(dev, clf_path)
    t_phase["25"] = time.perf_counter() - phase_t0 - sum(t_phase.values())

    # -- this slice: the paper figures, the SVM zoo and PCA, the double
    # backward (before the block: 31 times its kernels)
    plots_launches = plots_phase(dev)
    t_phase["29"] = time.perf_counter() - phase_t0 - sum(t_phase.values())
    svm_zoo_phase(dev, x2, y2)
    t_phase["30"] = time.perf_counter() - phase_t0 - sum(t_phase.values())
    second_launches, second_fields = double_backward_phase(dev, x2, y2)
    t_phase["31"] = time.perf_counter() - phase_t0 - sum(t_phase.values())
    variant_launches = [a + b for a, b in zip(variant_launches + [0, 0],
                                              second_launches)]

    # -- this slice: the bf16 shadows and the multi-rank paths ---------------
    # phase 26's cell and phase 27's ranks (the sweep, then 27(c)-(d); the
    # data-parallel cell) run in processes of their own, side by side,
    # while this one runs phases 20-23 and 12c, 26's recorded step, 27(b)'s
    # one-process layouts, 27(e) and 28; each is checked as it ends
    data_path = OUT_DIR / "modality5.npz"
    np.savez(data_path, x=ds.X.cpu().numpy(), y=ds.y.cpu().numpy())
    shadow_proc = start_ranks("shadow", 1, data_path, ("cuda:0", 100))
    sweep_ranks = start_ranks("sweep", MULTI_WORLD, data_path, ("cuda:0", 100))
    dp_ranks = start_ranks("dp", MULTI_WORLD, data_path,
                           ("cuda:0", DP_EPOCHS))
    activation_phase(dev)
    t_phase["20"] = time.perf_counter() - phase_t0 - sum(t_phase.values())
    api_launches = function_api_phase(dev)
    t_phase["21"] = time.perf_counter() - phase_t0 - sum(t_phase.values())
    grid_svm_rf_phase(dev)
    t_phase["22"] = time.perf_counter() - phase_t0 - sum(t_phase.values())
    preprocess_phase(dev)
    t_phase["23"] = time.perf_counter() - phase_t0 - sum(t_phase.values())
    table_launches += gan_tables_cli()
    t_phase["12c"] = time.perf_counter() - phase_t0 - sum(t_phase.values())
    shadow_step(ds)
    layouts = one_process_layouts(ds, DP_EPOCHS)
    cli_launches = multi_rank_cli(phase7_lines)
    nccl_phase(data_path)
    (shadow_out,), shadow_wall = join_ranks(shadow_proc)
    sweep_out, sweep_wall = join_ranks(sweep_ranks)
    dp_out, dp_wall = join_ranks(dp_ranks)
    print("phases 26-27: joined %.1f s (26's cell), %.1f s (the sweep ranks) "
          "and %.1f s (the data-parallel ranks) after their spawn" % (
              shadow_wall, sweep_wall, dp_wall))
    shadow_cell_check(shadow_out, cell[0])
    sharded_launches = sweep_checks(dev, sweep_out, cell[0])
    dp_checks(dp_out, layouts)
    t_phase["26-28"] = time.perf_counter() - phase_t0 - sum(t_phase.values())
    print("phase wall times: %s s; the script so far %.1f s" % (
        ", ".join("%s %.1f" % kv for kv in t_phase.items()),
        time.perf_counter() - script_t0))
    total = (launches + train_launches + fit_launches + table_launches
             + api_launches + collect_highest + sharded_launches
             + cli_launches + plots_launches)
    high_total = high_24 + collect_high
    print("kernel launches on the driven paths: mel_power: serving %d, "
          "training (phases 6-7) %d, phase 9 %d, phases 12-15 %d, phase 21 "
          "%d, phase 25 %d, phase 27(c) %d, phase 27(e) %d, phase 29 %d: "
          "%d; mel_power_high: phase 24 %d, phase 25 %d: %d; lstm_scan_fwd "
          "/ lstm_scan_bwd / lstm_scan_bwd_ext / lstm_scan_adj (phases "
          "17-18 and 31): %d / %d / %d / %d; phases 19, 20, 22, 23 and 30 "
          "launch no kernel" % (
              launches, train_launches, fit_launches, table_launches,
              api_launches, collect_highest, sharded_launches, cli_launches,
              plots_launches, total, high_24, collect_high, high_total,
              *variant_launches))

    print(gpu_line())
    lstm_source = "mrgan_tpu_torch/csrc/lstm_scan.cu"
    lstm_replaces = "mrgan_tpu/models/variant_nets.py:164"  # lax.scan
    print(json.dumps({"kernels": [{
        "name": "mel_power",
        "route": "cuda",
        "source": "mrgan_tpu_torch/csrc/mel_power.cu",
        "replaces": "mrgan_tpu/ops/mel_pallas.py:79",
        "launches": total,
        "max_abs_err": db_err,
        "ms": timing[f_main][0],
        "plain_ms": timing[f_main][1],
        "bound_ms": bound[f_main][0],
        "bound_by": bound[f_main][1],
        "library_ms": timing[f_main][2],
    }, {
        "name": "mel_power_high",
        "route": "cuda",
        "source": "mrgan_tpu_torch/csrc/mel_power.cu",
        "replaces": "mrgan_tpu/ops/mel_pallas.py:62",
        "launches": high_total,
        "max_abs_err": high_db_err,
        "ms": high_timing[f_main][0],
        "plain_ms": high_timing[f_main][2],
        "bound_ms": high_bounds[f_main][0],
        "bound_by": high_bounds[f_main][1],
        "library_ms": high_timing[f_main][3],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": lstm_source,
        "replaces": lstm_replaces,
        "launches": n,
        **lstm_fields[name],
    } for name, n in zip(("lstm_scan_fwd", "lstm_scan_bwd"),
                         variant_launches)] + [{
        "name": name,
        "route": "cuda",
        "source": lstm_source,
        "replaces": lstm_replaces,  # its second-order transpose
        "launches": n,
        **second_fields[name],
    } for name, n in zip(("lstm_scan_bwd_ext", "lstm_scan_adj"),
                         variant_launches[2:])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tables-rank"]:
        tables_rank_main(sys.argv[2:])
    else:
        main()
