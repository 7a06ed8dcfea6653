"""CLI for the offline preprocessing pipeline (reference processdata.py).

Port of ``mrgan_tpu/cli/preprocess.py``: raw acquisition pickles ->
processed MREO pickles over the 14 window configs (processdata.py:10-92),
each stream's pokes windowed and resampled as one batched gather + lerp on
the device. The same flags plus ``--device`` (default cuda; cuda without a
card raises):

    python -m mrgan_tpu_torch.cli.preprocess --raw-dir data_raw \\
        --out-dir data_processed --configs 0 7
"""

import argparse

from ..data import preprocess
from ..utils import device as device_lib


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Window and resample raw poke data around impact times."
    )
    parser.add_argument("--raw-dir", default="data_raw")
    parser.add_argument("--out-dir", default="data_processed")
    parser.add_argument(
        "--prefix", default="custom_",
        help="Output filename prefix (reference safety latch; '' writes "
             "loader-visible processed_*.pkl)",
    )
    parser.add_argument(
        "--configs", type=int, nargs="*", default=None,
        help="Indices into the 14 (duration, contact) configs; default all",
    )
    parser.add_argument("--device", default="cuda",
                        help="Torch device for the windows: cuda (default), "
                             "cuda:N or cpu; cuda without a card raises")
    args = parser.parse_args(argv)
    device = device_lib.resolve(args.device)
    configs = (
        [preprocess.CONFIGS[i] for i in args.configs]
        if args.configs is not None
        else None
    )
    preprocess.run(raw_dir=args.raw_dir, out_dir=args.out_dir,
                   configs=configs, prefix=args.prefix, device=device)


if __name__ == "__main__":
    main()
