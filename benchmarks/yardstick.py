"""The yardstick: the card's published peaks, the least time the log-mel
could take, and the floating-point work of each cell's unit of work,
computed from the configuration's shapes. Nothing here reads the program.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, at 700 W). Work is
counted as the function needs it, not as a kernel happens to do it: a
matrix product of (m, k) by (k, n) is 2mkn operations.
"""

import math

import numpy as np

from reference import mel as ref_mel

FP32_PEAK = 67e12      # CUDA cores, float32
TF32_PEAK = 495e12     # tensor cores
BF16_PEAK = 989e12
HBM_BYTES_S = 3.35e12


def mel_bound(n_rows, row_len, frames, n_fft=ref_mel.N_FFT,
              n_mels=ref_mel.N_MELS):
    """(seconds, "bytes" | "operations"): the least time for the mel power
    of ``frames`` frames of ``n_rows`` reflect-padded audio rows of
    ``row_len`` samples. Per frame: the window (N), a real FFT of N points
    (2.5 N log2 N), the power (3 a bin) and the projection onto the
    filterbank's nonzero weights (2 each), in float32 on the CUDA cores;
    bytes: the audio and the nonzero weights read once, the mel power
    written once, at HBM's rate."""
    n_bins = n_fft // 2 + 1
    nonzero = int(np.count_nonzero(ref_mel.filterbank(n_fft=n_fft,
                                                       n_mels=n_mels)))
    per_frame = n_fft + 2.5 * n_fft * math.log2(n_fft) + 3 * n_bins \
        + 2 * nonzero
    ops_s = per_frame * frames / FP32_PEAK
    bytes_s = 4 * (n_rows * row_len + nonzero + frames * n_mels) / HBM_BYTES_S
    return max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s
                                 else "bytes")


def mel_frame_flops(n_fft=ref_mel.N_FFT, n_mels=ref_mel.N_MELS):
    nonzero = int(np.count_nonzero(ref_mel.filterbank(n_fft=n_fft,
                                                       n_mels=n_mels)))
    return (n_fft + 2.5 * n_fft * math.log2(n_fft) + 3 * (n_fft // 2 + 1)
            + 2 * nonzero)


def macs(layers):
    return sum(i * o for i, o in layers)


def disc_layers(cfg):
    dims = [cfg["features"], *cfg["disc_trunk"], cfg["disc_mid"]]
    return list(zip(dims[:-1], dims[1:])) + [(cfg["disc_mid"],
                                              cfg["num_classes"])]


def gen_layers(cfg):
    h = cfg["gen_hidden"]
    return [(cfg["noise_size"], h), (h, h), (h, cfg["features"])]


def gan_fold_step_flops(cfg):
    """One fold's discriminator update and generator update, batch b:

    - G forward, b rows (no gradient);
    - D forward over 3b rows [labeled | unlabeled | fake], and its
      backward: every weight gradient, every input gradient but the
      first layer's;
    - G forward, b rows; D forward over 2b rows [fake | unlabeled]; D
      backward to its input through the layers up to ``mid`` (no weight
      gradients, the logits unused); G backward: every weight gradient,
      every input gradient but the first layer's."""
    b = cfg["batch_size"]
    md, mg = macs(disc_layers(cfg)), macs(gen_layers(cfg))
    d_first = cfg["features"] * cfg["disc_trunk"][0]
    g_first = cfg["noise_size"] * cfg["gen_hidden"]
    out_layer = cfg["disc_mid"] * cfg["num_classes"]
    per_row = (mg                                # G forward (disc update)
               + 3 * md + 3 * md + 3 * (md - d_first)
               + mg                              # G forward (gen update)
               + 2 * md + 2 * (md - out_layer)
               + mg + (mg - g_first))
    return 2 * b * per_row


def ae_layers(cfg):
    dims = [cfg["features"], *cfg["encoder"]]
    enc = list(zip(dims[:-1], dims[1:]))
    return enc + [(o, i) for i, o in reversed(enc)]


def ae_fold_step_flops(cfg):
    """One fold's autoencoder update, batch b: the forward, every weight
    gradient, every input gradient but the first layer's."""
    layers = ae_layers(cfg)
    first = layers[0][0] * layers[0][1]
    return 2 * cfg["batch_size"] * (3 * macs(layers) - first)


def score_poke_flops(cfg):
    """One poke classified: its log-mel frames (as ``mel_bound`` counts
    them) and the eval-mode discriminator's forward."""
    frames = ref_mel.n_frames(cfg["audio_len"])
    return frames * mel_frame_flops() + 2 * macs(disc_layers(cfg))


FOLD_STEP_FLOPS = {"gan": gan_fold_step_flops, "ae": ae_fold_step_flops}
