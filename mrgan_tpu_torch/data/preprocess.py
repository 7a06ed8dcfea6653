"""Offline preprocessing: raw acquisition pickles -> processed MREO pickles,
and the impact windowing that serving shares.

Port of ``mrgan_tpu/data/preprocess.py`` (processdata.py:10-92 semantics):

- 14 (durationOfContact, contactAccelLength) configs (processdata.py:10);

- force/pressure/temperature windows: [impact-0.1 s, impact+duration], the
  post index clamping to the stream end, resampled to 100*duration points
  on a linspace between the window's first and last sample times;
- force taxels 3 and 4; temperature Celsius channel [:, 1];
- contact mic: impact +/- duration/2 with the reference's off-by-one grid
  start, resampled to 48000*duration points;
- accelerometer streams are read but never stored, like the reference;
- the output pickle schema and the 'custom_processed_0.1sbefore_...' writer
  name latch (loaders read the unprefixed 'processed_...' name).

Ragged streams are padded on the host and each stream's pokes run as one
batched gather+lerp on ``device`` (ops.resample), in float32 like the JAX
package; the offline ``run`` stores float64, the reference's on-disk type.
"""

import glob
import os
import pickle
import sys
import time

import numpy as np
import torch

from .. import MATERIALS
from ..ops import resample

# (durationOfContact, contactAccelLength) pairs, processdata.py:10
CONFIGS = list(
    zip(
        [4, 3, 2, 1, 0.5, 0.2, 0.1, 4, 4, 4, 4, 4, 4, 4],
        [0.2, 0.2, 0.2, 0.2, 0.2, 0.2, 0.2, 1, 0.7, 0.5, 0.3, 0.2, 0.1, 0.05],
    )
)

TAXEL_1, TAXEL_2 = 3, 4  # processdata.py:51-53


class ShortWindowError(ValueError):
    """A poke whose sensor stream holds no samples to window (the JAX
    package fails on such a poke too, in its gather). The collection
    stack's classifier hook reports it and goes on."""


def _padded(times, values, impacts, device):
    t, v, m = resample.make_padded(values, times)
    # float64 host times are cast to float32 before any arithmetic, as the
    # JAX package does (data/preprocess.py:57,66)
    return (torch.from_numpy(t.astype(np.float32)).to(device),
            torch.from_numpy(v).to(device), torch.from_numpy(m).to(device),
            torch.from_numpy(np.asarray(impacts, np.float32)).to(device))


def _batched_window(times, values, impacts, pre, post, num_out, device):
    """Host ragged lists -> device window+lerp -> (B, num_out) numpy."""
    out, grid = resample.window_resample(
        *_padded(times, values, impacts, device), pre, post, num_out)
    return out.cpu().numpy(), grid.cpu().numpy()


def _batched_window_centered(times, values, impacts, half, num_out, device):
    out, grid = resample.window_resample_centered(
        *_padded(times, values, impacts, device), half, num_out)
    return out.cpu().numpy(), grid.cpu().numpy()


def process_sequences(raw, duration, contact_len, streams=None,
                      out_dtype=np.float32, *, device):
    """Process one raw batch dict (the per-file schema of
    collectdataPoke.py's saves) into the processed per-object schema.

    Returns dict with forceTime/force0/force1/pressureTime/pressure0/
    pressure1/temperatureTime/temperature/contactTime/contact lists of numpy
    arrays. ``streams`` limits the work to a subset of {"force", "pressure",
    "temperature", "contact"} (None = all); the window math runs on
    ``device``.
    """
    if streams is None:
        streams = {"force", "pressure", "temperature", "contact"}
    n_ft = int(100 * duration)
    n_c = int(48000 * contact_len)
    impacts = [float(t) for t in raw["collisionTime"]]
    keys = {"force": ("RGripRFingerTime", "RGripRFingerForce"),
            "pressure": ("RGripRFingerTime", "RGripRFingerPressure"),
            "temperature": ("temperatureTime", "temperatureRaw"),
            "contact": ("contactmicTime", "contactmic")}
    for name in sorted(streams):
        for key in keys[name]:
            for i, x in enumerate(raw[key]):
                if len(x) == 0:
                    raise ShortWindowError(
                        "poke %d of %d: %s holds no samples to window"
                        % (i, len(raw[key]), key))

    def window(times, values, num_out):
        return _batched_window(times, values, impacts, 0.1, duration,
                               num_out, device)

    out = {}
    if streams & {"force", "pressure"}:
        force_t = [np.asarray(t, np.float64) for t in raw["RGripRFingerTime"]]
    for name, key in (("force", "RGripRFingerForce"),
                      ("pressure", "RGripRFingerPressure")):
        if name in streams:
            traces = [np.asarray(x, np.float32) for x in raw[key]]
            v0, grid = window(force_t, [x[:, TAXEL_1] for x in traces], n_ft)
            v1, _ = window(force_t, [x[:, TAXEL_2] for x in traces], n_ft)
            out[name + "Time"] = list(np.asarray(grid, out_dtype))
            out[name + "0"] = list(np.asarray(v0, out_dtype))
            out[name + "1"] = list(np.asarray(v1, out_dtype))
    if "temperature" in streams:
        temp_t = [np.asarray(t, np.float64) for t in raw["temperatureTime"]]
        temp = [np.asarray(x, np.float32) for x in raw["temperatureRaw"]]
        tc, t_grid = window(temp_t, [x[:, 1] for x in temp], n_ft)
        out["temperatureTime"] = list(np.asarray(t_grid, out_dtype))
        out["temperature"] = list(np.asarray(tc, out_dtype))
    if "contact" in streams:
        con_t = [np.asarray(t, np.float64) for t in raw["contactmicTime"]]
        con = [np.asarray(c, np.float32) for c in raw["contactmic"]]
        cm, c_grid = _batched_window_centered(con_t, con, impacts,
                                              contact_len / 2.0, n_c, device)
        out["contactTime"] = list(np.asarray(c_grid, out_dtype))
        out["contact"] = list(np.asarray(cm, out_dtype))
    return out


def _object_name(filename):
    return "_".join(os.path.basename(filename).split("_")[1:3])


def process_material(material, duration, contact_len, raw_dir="data_raw",
                     verbose=True, out_dtype=np.float32, *, device):
    """All raw files of one material -> {object: processed streams}, the
    windows computed on ``device``."""
    filenames = sorted(glob.glob(os.path.join(raw_dir,
                                              "newdata_%s*.pkl" % material)))
    all_data = {}
    for filename in filenames:
        obj = _object_name(filename)
        with open(filename, "rb") as f:
            raw = pickle.load(f, encoding="latin1")
        if verbose:
            print("Processing:", filename)
            tt = time.time()
        processed = process_sequences(raw, duration, contact_len,
                                      out_dtype=out_dtype, device=device)
        dest = all_data.setdefault(obj, {k: [] for k in processed})
        for k, v in processed.items():
            dest[k].extend(v)
        if verbose:
            print("Done processing file", time.time() - tt, "s")
            sys.stdout.flush()
    return all_data


def run(raw_dir="data_raw", out_dir="data_processed", configs=None,
        prefix="custom_", verbose=True, out_dtype=np.float64, *, device):
    """The full pipeline over all configs x materials (processdata.py's
    module loop), the windows computed on ``device``.

    ``prefix``: the reference writes 'custom_processed_...' while its loaders
    read 'processed_...' (a safety latch so a rerun can't clobber the
    distributed dataset); pass prefix='' to write loader-visible files.
    """
    os.makedirs(out_dir, exist_ok=True)
    for duration, contact_len in (configs or CONFIGS):
        if verbose:
            print("-" * 50)
            print("Force/temperature duration:", duration,
                  "| Contact mic/accel duration:", contact_len)
            print("-" * 50)
        for material in MATERIALS:
            all_data = process_material(material, duration, contact_len,
                                        raw_dir, verbose,
                                        out_dtype=out_dtype, device=device)
            out_path = os.path.join(
                out_dir,
                "%sprocessed_0.1sbefore_%s_times_%.2f_%.2f.pkl"
                % (prefix, material, duration, contact_len),
            )
            with open(out_path, "wb") as f:
                pickle.dump(all_data, f, pickle.HIGHEST_PROTOCOL)
