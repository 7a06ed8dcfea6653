"""CLI mirroring others/mr_nn_activation_map.py: train the supervised MLP on
one modality, compute input-gradient class activation maps for sample
pokes, and save them.

Port of ``mrgan_tpu/cli/activation_map.py``: the same flags plus
``--device`` (default cuda; cuda without a card raises):

    python -m mrgan_tpu_torch.cli.activation_map -m 2 --synthetic
    python -m mrgan_tpu_torch.cli.activation_map -m 2 --synthetic \\
        --synthetic-pokes 2 --epochs 1 --samples 4 --device cpu

The fold is the JAX CLI's: fold 0 of ``stratified_splits(seed)`` at 100 %
labels, its rows picked by ``protocol.fold_indices`` and scaled on the
device (``gan.scaled_rows``), padded to a multiple of 128 as the JAX
package's ``MlpConfig`` pads. The maps
(``activation_maps.npy``, (samples, features)) and the inputs they explain
(``activation_inputs.npy``) are always written to ``--out-dir``; the
heatmap figure (``activation_maps.png``) only where matplotlib imports.
"""

import argparse
import os

import numpy as np
import torch

from ..data import mreo
from ..train import gan, mlp, protocol
from ..utils import device as device_lib
from ..utils import rng as rng_util
from ..variants import activation_maps


def build_parser():
    parser = argparse.ArgumentParser(
        description="Class activation maps for the supervised MLP.")
    parser.add_argument("-m", "--modality", type=int, default=2)
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--samples", type=int, default=8,
                        help="Test pokes to map")
    parser.add_argument("--out-dir", default="plots")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--synthetic-pokes", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="Torch device to train on: cuda (default), "
                             "cuda:N or cpu; cuda without a card raises")
    return parser


def _figure(path, cams, x_test):
    """The reference's heatmaps, one row a poke with its trace over it;
    False where matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(len(cams), 1, figsize=(10, 1.2 * len(cams)))
    for i, ax in enumerate(np.atleast_1d(axes)):
        ax.imshow(cams[i : i + 1], cmap="jet", aspect="auto")
        norm = x_test[i]
        norm = (norm - norm.min()) / max(norm.max() - norm.min(), 1e-9) - 0.5
        ax.plot(norm, "w", linewidth=0.6)
        ax.set_yticks([])
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return True


def main(argv=None):
    make_maps(argv)


def make_maps(argv=None):
    """The CLI's work; returns what it mapped: {"error", "params" (the
    fold's, a fold axis of 1), "x" and "y_target" (the padded test rows and
    their one-hot targets, on the device), "maps" (numpy, unpadded),
    "valid_dim", "paths"}."""
    args = build_parser().parse_args(argv)
    device = device_lib.resolve(args.device)
    if device.type == "cuda":
        device_lib.set_fp32_policy()

    x, y = mreo.load_features(
        modalities=args.modality,
        synthetic_seed=args.seed if args.synthetic else None,
        synthetic_kwargs={"pokes_per_object": args.synthetic_pokes},
        device=device)
    cfg = mlp.MlpConfig(epochs=args.epochs, pad_multiple=128)
    ds = protocol.DeviceDataset(x, y, cfg.pad_multiple, cfg.pad_min,
                                device=device)
    valid_dim = ds.valid_dim
    rng = np.random.RandomState(args.seed)
    (tr, te), *_ = protocol.stratified_splits(ds.y_host, n_splits=6,
                                              seed=args.seed)
    lab, _, train, test = (
        gan.index_tensor(a[None], device) for a in protocol.fold_indices(
            ds.y_host, tr, te, 100, None, cfg.num_classes, rng))
    x_lab, x_test = gan.scaled_rows(ds.X, train, lab, test)
    generator = rng_util.make_generator(args.seed, device)
    err, aux = mlp.train_folds(generator, x_lab, ds.y[lab], x_test,
                               ds.y[test], valid_dim=valid_dim, cfg=cfg)
    print("Test error:", float(err[0]))
    params = activation_maps.fold_slice(aux["params"])

    x_test = x_test[0, : args.samples]
    y_target = torch.eye(cfg.num_classes, device=device)[
        ds.y[test][0, : args.samples]]
    cams = activation_maps.mlp_saliency(params, x_test, y_target)
    cams = cams[:, :valid_dim].cpu().numpy()
    inputs = x_test[:, :valid_dim].cpu().numpy()

    os.makedirs(args.out_dir, exist_ok=True)
    paths = [os.path.join(args.out_dir, name) for name in
             ("activation_maps.npy", "activation_inputs.npy")]
    np.save(paths[0], cams)
    np.save(paths[1], inputs)
    png = os.path.join(args.out_dir, "activation_maps.png")
    if _figure(png, cams, inputs):
        paths.append(png)
    for path in paths:
        print("Wrote", path)
    return {"error": float(err[0]), "params": params, "x": x_test,
            "y_target": y_target, "maps": cams, "valid_dim": valid_dim,
            "paths": paths}


if __name__ == "__main__":
    main()
