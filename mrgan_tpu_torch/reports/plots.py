"""Paper-figure generation (reference paperplotly.py:1-202).

Port of ``mrgan_tpu/reports/plots.py``. Three figure families:

- table1: accuracy vs percent labeled per modality combination;
- table5: accuracy vs contact duration;
- traces: each material's sample force and temperature traces and a
  log-mel spectrogram heatmap of its contact-mic window.

Computing and drawing are apart. The curves are the published arrays
(copied; the defaults) or a table CLI's sweep checkpoint
(:func:`curves_from_checkpoint`). :func:`sample_trace_data` computes the
traces and the six log-mel blocks on ``device`` through
``ops.mel.frontend_logmel``: one launch of the mel kernel on a CUDA device,
the plain path on the CPU. The drawing functions then render as the JAX
package does, with plotly where it is installed, else matplotlib, both
imported at first use; where neither is installed (as on the machine with
the card) they raise an ``ImportError`` that names both.
"""

import json
import os

import numpy as np
import torch

# Published accuracy arrays (paperplotly.py:16-23,49-54; = BASELINE.md)
TABLE1_X = [1, 2, 4, 8, 16, 50, 100]
TABLE1 = {
    "Force": [62.1, 70.4, 72.2, 77.7, 79.8, 85.8, 87.9],
    "Temperature": [53.8, 59.0, 64.1, 68.1, 69.0, 80.0, 82.1],
    "Contact mic": [42.9, 53.9, 62.6, 67.5, 73.4, 79.8, 83.1],
    "Force, Temperature": [74.3, 81.4, 85.6, 88.5, 90.2, 94.2, 95.3],
    "Force, Contact mic": [58.2, 67.5, 73.8, 80.2, 84.7, 89.7, 91.8],
    "Temperature, Contact mic": [52.4, 68.3, 79.2, 84.9, 87.4, 91.2, 92.2],
    "Force, Temperature, Contact mic": [62.8, 75.4, 85.6, 89.4, 92.0, 95.4, 96.2],
}
TABLE5_X = [0.1, 0.2, 0.5, 1, 2, 3, 4]
TABLE5_X_CONTACT = [0.05, 0.1, 0.2, 0.3, 0.5, 0.7, 1]
TABLE5 = {
    "Force": [70.9, 75.1, 81.8, 86.9, 87.6, 87.6, 87.9],
    "Temperature": [58.9, 64.4, 70.4, 73.9, 77.5, 80.3, 82.1],
    "Contact mic": [63.3, 77.0, 83.1, 82.4, 83.8, 84.0, 84.6],
    "Force, Temperature": [84.4, 88.6, 92.4, 94.4, 95.0, 94.8, 95.3],
}

# Mapping from modality index (mr_gan.py:49-62) to curve name
MODALITY_CURVES = {
    0: "Force", 1: "Temperature", 2: "Force, Temperature", 3: "Contact mic",
    4: "Temperature, Contact mic", 5: "Force, Temperature, Contact mic",
    6: "Force, Contact mic",
}


def curves_from_checkpoint(path, table=1):
    """Rebuild accuracy curves from a table-CLI sweep checkpoint JSONL:
    {curve name: (x values, accuracies in %)}."""
    by_curve = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            cell, result = rec["cell"], rec["result"]
            if cell.get("table") != table:
                continue
            name = MODALITY_CURVES.get(cell.get("modality"))
            if name is None:
                continue
            xval = cell.get("percent", cell.get("ft_time", cell.get("c_time")))
            acc = 100.0 * (1.0 - float(np.mean(result)))
            by_curve.setdefault(name, []).append((xval, acc))
    return {
        name: tuple(zip(*sorted(points))) for name, points in by_curve.items()
    }


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or an ImportError that names
    both renderers."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the paper figures render with plotly or "
                          "matplotlib, and neither is installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _line_chart(curves, title, xlabel, ylabel, out_html, y_range=None,
                presentation=False):
    """Render with plotly when available (the reference's output format),
    else matplotlib (PNG + minimal HTML wrapper).

    ``presentation``: the larger-type/thicker-mark styling of
    others/paperplotly_presentation.py.
    """
    fs = {"title": 28 if presentation else 20,
          "axis": 24 if presentation else 18,
          "tick": 22 if presentation else 18,
          "legend": 20 if presentation else 14}
    lw = 6 if presentation else 4
    ms = 14 if presentation else 10
    try:
        import plotly
        import plotly.graph_objs as go
    except ImportError:
        plt = _pyplot()
    else:
        data = [
            go.Scatter(x=list(x), y=list(y), name=name,
                       line=dict(width=lw), mode="lines+markers",
                       marker=dict(size=ms))
            for name, (x, y) in curves.items()
        ]
        layout = dict(
            title=title, titlefont=dict(size=fs["title"]),
            xaxis=dict(title=xlabel, showgrid=True,
                       titlefont=dict(size=fs["axis"]),
                       tickfont=dict(size=fs["tick"])),
            yaxis=dict(title=ylabel, showgrid=True,
                       titlefont=dict(size=fs["axis"]),
                       tickfont=dict(size=fs["tick"]),
                       **({"range": y_range} if y_range else {})),
            width=1200, height=500,
            legend=dict(font=dict(size=fs["legend"])),
            showlegend=True,
        )
        plotly.offline.plot({"data": data, "layout": layout},
                            filename=out_html, auto_open=False)
        return out_html

    fig, ax = plt.subplots(figsize=(12, 5))
    for name, (x, y) in curves.items():
        ax.plot(x, y, marker="o", linewidth=lw / 2, markersize=ms / 2,
                label=name)
    ax.set_title(title, fontsize=fs["title"] * 0.6)
    ax.set_xlabel(xlabel, fontsize=fs["axis"] * 0.6)
    ax.set_ylabel(ylabel, fontsize=fs["axis"] * 0.6)
    if y_range:
        ax.set_ylim(y_range)
    ax.grid(True)
    ax.legend(fontsize=fs["legend"] * 0.7)
    png = out_html.replace(".html", ".png")
    fig.savefig(png, dpi=120, bbox_inches="tight")
    plt.close(fig)
    with open(out_html, "w") as f:
        f.write(f'<html><body><img src="{os.path.basename(png)}"/>'
                "</body></html>")
    return out_html


def plot_table1(out_dir="plots", checkpoint=None, presentation=False):
    os.makedirs(out_dir, exist_ok=True)
    curves = ({n: (TABLE1_X, v) for n, v in TABLE1.items()}
              if checkpoint is None else curves_from_checkpoint(checkpoint, 1))
    name = "table1_presentation.html" if presentation else "table1.html"
    return _line_chart(
        curves, "Accuracy with Varying Labeled Training Data",
        "Percent of Training Data Labeled (%)", "Accuracy (%)",
        os.path.join(out_dir, name), presentation=presentation)


def plot_table5(out_dir="plots", checkpoint=None, presentation=False):
    os.makedirs(out_dir, exist_ok=True)
    if checkpoint is None:
        curves = {
            n: (TABLE5_X_CONTACT if n == "Contact mic" else TABLE5_X, v)
            for n, v in TABLE5.items()
        }
    else:
        curves = curves_from_checkpoint(checkpoint, 5)
    name = "table5_presentation.html" if presentation else "table5.html"
    return _line_chart(
        curves, "Accuracy with Varying Duration of Contact",
        "Length of Interaction (s)", "Accuracy (%)",
        os.path.join(out_dir, name), y_range=[50, 100],
        presentation=presentation)


def sample_trace_data(device, forcetemp_time=4, contactmic_time=0.2,
                      data_dir="data_processed", synthetic_seed=None,
                      n_mels=128):
    """What the trace figures show (paperplotly.py:75-201): the first poke
    of each material's first object, from the processed pickles or, with a
    seed or without them, the synthetic set the JAX package draws (2 pokes
    an object). Returns {material: {"force", "temperature": (n,) float32,
    "contact": the contact-mic window, float32, "logmel": (n_mels, T)
    float32 dB}} and the traces' time axis (n,). The six contact windows
    go through ``frontend_logmel`` on ``device`` in one call: the mel
    kernel on a CUDA device."""
    from .. import MATERIALS
    from ..data import mreo, synthetic
    from ..ops import mel as mel_ops

    if device is None:
        raise ValueError("device= is required (nothing falls back to the "
                         "CPU)")
    if synthetic_seed is not None or not mreo.have_processed(
            data_dir, forcetemp_time, contactmic_time):
        data = synthetic.generate_processed(
            seed=synthetic_seed or 0, forcetemp_time=forcetemp_time,
            contactmic_time=contactmic_time, pokes_per_object=2)
        first = {m: next(iter(data[m].values())) for m in MATERIALS}
    else:
        first = {m: next(iter(mreo._load_material(
            data_dir, m, forcetemp_time, contactmic_time).values()))
            for m in MATERIALS}
    audio = np.stack([np.asarray(first[m]["contact"][0], np.float32)
                      for m in MATERIALS])
    logm = mel_ops.frontend_logmel(
        torch.as_tensor(audio, device=torch.device(device)), n_mels=n_mels,
        flatten=False).cpu().numpy()
    traces = {m: {"force": np.asarray(first[m]["force0"][0]),
                  "temperature": np.asarray(first[m]["temperature"][0]),
                  "contact": audio[i], "logmel": logm[i]}
              for i, m in enumerate(MATERIALS)}
    n = len(traces[MATERIALS[0]]["force"])
    return traces, np.linspace(-0.1, forcetemp_time, n)


def plot_sample_traces(out_dir="plots", forcetemp_time=4, contactmic_time=0.2,
                       data_dir="data_processed", synthetic_seed=None,
                       n_mels=128, *, device):
    """Per-material sample traces and log-mel heatmaps
    (paperplotly.py:75-201), computed by :func:`sample_trace_data` on
    ``device`` and drawn with matplotlib. Returns the PNG paths."""
    traces, t = sample_trace_data(device, forcetemp_time, contactmic_time,
                                  data_dir, synthetic_seed, n_mels)
    plt = _pyplot()
    os.makedirs(out_dir, exist_ok=True)
    outputs = []
    for kind in ("force", "temperature"):
        fig, ax = plt.subplots(figsize=(8, 4))
        for m, tr in traces.items():
            ax.plot(t, tr[kind], label=m)
        ax.set_xlabel("Time (s)")
        ax.set_ylabel("Force (N)" if kind == "force" else "Temperature (C)")
        ax.legend(fontsize=8)
        path = os.path.join(out_dir, f"traces_{kind}.png")
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        outputs.append(path)

    fig, axes = plt.subplots(2, 3, figsize=(12, 6))
    for ax, (m, tr) in zip(axes.ravel(), traces.items()):
        ax.imshow(tr["logmel"], aspect="auto", origin="lower", cmap="magma")
        ax.set_title(m, fontsize=10)
    fig.suptitle("Log-mel spectrograms (contact microphone)")
    path = os.path.join(out_dir, "traces_melspectrogram.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    outputs.append(path)
    return outputs
