"""CLI for figure generation (reference paperplotly.py).

Port of ``mrgan_tpu/cli/plots.py``, with the same flags plus ``--device``
(default cuda; cuda without a card raises): the accuracy curves of Tables 1
and 5 (the published numbers, or ``--checkpoint`` to plot a sweep you ran)
and the sample trace and spectrogram figures, whose log-mel blocks the mel
kernel computes on the card:

    python -m mrgan_tpu_torch.cli.plots --synthetic --device cpu

Drawing needs plotly or matplotlib (``reports.plots``).
"""

import argparse

from ..reports import plots
from ..utils import device as device_lib


def main(argv=None):
    parser = argparse.ArgumentParser(description="Generate paper figures.")
    parser.add_argument("--out-dir", default="plots")
    parser.add_argument("--checkpoint", default=None,
                        help="Sweep checkpoint JSONL to plot instead of the "
                             "published numbers")
    parser.add_argument("--data-dir", default="data_processed")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--presentation", action="store_true",
                        help="Presentation styling "
                             "(others/paperplotly_presentation.py)")
    parser.add_argument("--device", default="cuda",
                        help="Torch device of the spectrograms: cuda "
                             "(default), cuda:N or cpu")
    args = parser.parse_args(argv)
    device = device_lib.resolve(args.device)
    if device.type == "cuda":
        device_lib.set_fp32_policy()

    made = [
        plots.plot_table1(args.out_dir, args.checkpoint, args.presentation),
        plots.plot_table5(args.out_dir, args.checkpoint, args.presentation),
    ]
    made += plots.plot_sample_traces(
        args.out_dir, data_dir=args.data_dir,
        synthetic_seed=0 if args.synthetic else None, device=device)
    for path in made:
        print("Wrote", path)


if __name__ == "__main__":
    main()
