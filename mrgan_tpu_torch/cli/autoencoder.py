"""CLI mirroring others/mr_gan_autoencoder.py: semi-supervised GAN with
dense-autoencoder pretraining on raw contact waveforms (modality 3 in that
variant returns raw audio; encoderNodes [1024, 512, 256] at :309).

Port of ``mrgan_tpu/cli/autoencoder.py``: the same flags plus ``--device``
(default cuda; cuda without a card raises), the same lines:

    python -m mrgan_tpu_torch.cli.autoencoder -t 1 --synthetic
    python -m mrgan_tpu_torch.cli.autoencoder -t 1 --synthetic \\
        --synthetic-pokes 2 --epochs 1 --percents 100 --seed 0 --device cpu

``--epochs`` sets the GAN's depth; the autoencoder trains its 100 epochs.
The raw waveforms skip the mel frontend, so no CUDA kernel runs here.
"""

import argparse

import numpy as np

from .. import MATERIALS, MODALITY_NAMES
from ..data import mreo
from ..train import gan
from ..utils import device as device_lib
from ..utils import metrics as M
from ..variants import autoencoder


def raw_contact_dataset(seed, pokes_per_object=100, synthetic=True):
    """The variant's modality 3 = RAW contact waveforms
    (mr_gan_autoencoder.py:57-58), not the mel features: (x (N, 9,600)
    float32, y (N,) int32) as numpy, materials then objects in order. The
    processed pickles of ``data_processed`` are read where they exist and
    ``synthetic`` is off, else the synthetic set of ``seed`` is made."""
    data_dir = "data_processed"
    if synthetic or not mreo.have_processed(data_dir):
        data = mreo._generate_processed_memo(
            seed, 4.0, 0.2, pokes_per_object=pokes_per_object)
        per_material = [data[m] for m in MATERIALS]
    else:
        per_material = [mreo._load_material(data_dir, m, 4, 0.2)
                        for m in MATERIALS]
    xs, ys = [], []
    for m, objects in enumerate(per_material):
        for obj in objects.values():
            arr = np.asarray(obj["contact"], np.float32)
            xs.append(arr)
            ys.append(np.full(len(arr), m, np.int32))
    return np.concatenate(xs), np.concatenate(ys)


def build_parser():
    parser = argparse.ArgumentParser(
        description="Semi-supervised GAN with autoencoder pretraining.")
    parser.add_argument("-t", "--tables", nargs="+", required=True)
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--synthetic-pokes", type=int, default=100)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--encoder-nodes", type=int, nargs="+",
                        default=[1024, 512, 256])
    parser.add_argument("--percents", type=int, nargs="+",
                        default=[1, 2, 4, 8, 16, 50, 100])
    parser.add_argument("--device", default="cuda",
                        help="Torch device to train on: cuda (default), "
                             "cuda:N or cpu; cuda without a card raises")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = device_lib.resolve(args.device)
    if device.type == "cuda":
        device_lib.set_fp32_policy()
    seed = np.random.randint(2**31 - 1) if args.seed is None else args.seed

    if "1" in args.tables:
        M.header("Testing various amounts of labeled training data")
        M.modality_header(MODALITY_NAMES[3])
        x, y = raw_contact_dataset(seed, args.synthetic_pokes, args.synthetic)
        ae_cfg = autoencoder.AeConfig(nodes=tuple(args.encoder_nodes))
        gan_cfg = gan.GanConfig(epochs=args.epochs)
        for percent in args.percents:
            M.subheader("Percentage of training data labeled: %d%%" % percent)
            errs = autoencoder.run_ae_gan_cell(
                x, y, percent, ae_cfg=ae_cfg, gan_cfg=gan_cfg, seed=seed,
                device=device)
            for e in errs:
                M.p("Test accuracy:", 1.0 - e)
            M.p("Average accuracy:", float(np.mean(1.0 - errs)))


if __name__ == "__main__":
    main()
