"""Drive the PyTorch port's serving path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root, one CUDA device

Phases (any failure raises and the script exits non-zero):

1. The card (``nvidia-smi`` name and power limit) and the fp32 numeric policy.
2. Build ``mrgan_tpu_torch/csrc/mel_power.cu`` with nvcc for sm_90a.
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

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA
device.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from mrgan_tpu_torch import MATERIALS
from mrgan_tpu_torch.models import nets
from mrgan_tpu_torch.ops import features, mel, mel_cuda
from mrgan_tpu_torch.serve import MaterialClassifier
from mrgan_tpu_torch.train import gan
from mrgan_tpu_torch.utils import device as numeric

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


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; "
                           "torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    print(gpu_line())
    print(numeric.set_fp32_policy())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(sys.version.split()[0], "torch", torch.__version__, "cuda",
          torch.version.cuda, "sms", sms)

    t0 = time.perf_counter()
    mel_cuda.build()
    print("built %s in %.3f s" % (mel_cuda.library_path().name,
                                  time.perf_counter() - t0))
    for line in mel_cuda.build_log.splitlines():
        if "registers" in line or "spill" in line:
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

    timing = {}
    for n, audio_len in ((1, AUDIO_LEN), (6, AUDIO_LEN), (72, AUDIO_LEN),
                         (512, 48000)):
        audio = torch.from_numpy(np.random.RandomState(2).randn(
            n, audio_len).astype(np.float32) * 100).to(dev)
        t = mel.num_frames(audio_len, HOP)
        padded = mel.reflect_pad(audio, N_FFT).contiguous()
        frames = padded.unfold(-1, N_FFT, HOP).reshape(-1, N_FFT)
        kernel_ms, plain_ms = [], []
        for _ in range(2):  # in turns: plain, kernel, kernel, plain
            plain_ms.append(cuda_ms(
                lambda: mel_cuda.mel_power_reference(frames)))
            kernel_ms.append(cuda_ms(
                lambda: mel_cuda.mel_power_framed(padded, t, HOP)))
            kernel_ms.append(cuda_ms(
                lambda: mel_cuda.mel_power_framed(padded, t, HOP)))
            plain_ms.append(cuda_ms(
                lambda: mel_cuda.mel_power_reference(frames)))
        f = n * t
        timing[f] = (statistics.median(kernel_ms), statistics.median(plain_ms))
        gflop = 2 * 2 * N_FFT * (N_FFT // 2 + 1) * f / 1e9
        print("mel_power F=%d %s: kernel %.4f ms (%.1f TFLOP/s), plain "
              "%.4f ms; runs %s / %s" % (
                  f, mel_cuda.describe(mel_cuda._layout(f, sms), f),
                  timing[f][0],
                  gflop / timing[f][0], timing[f][1],
                  ["%.4f" % v for v in kernel_ms],
                  ["%.4f" % v for v in plain_ms]))
        print("mel_power F=%d device time: kernel %s (row centers, DFT "
              "kernel, bin-group sum), plain %s" % (
                  f, fmt_ms(device_ms(
                      lambda: mel_cuda.mel_power_framed(padded, t, HOP))),
                  fmt_ms(device_ms(
                      lambda: mel_cuda.mel_power_reference(frames)))))
    f_main = 72 * mel.num_frames(AUDIO_LEN, HOP)

    print(gpu_line())
    print(json.dumps({"kernels": [{
        "name": "mel_power",
        "route": "cuda",
        "source": "mrgan_tpu_torch/csrc/mel_power.cu",
        "replaces": "mrgan_tpu/ops/mel_pallas.py:79",
        "launches": launches,
        "max_abs_err": db_err,
        "ms": timing[f_main][0],
        "plain_ms": timing[f_main][1],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
