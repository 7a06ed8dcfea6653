"""Impact windowing of raw acquisition batches (the serving half).

Port of ``process_sequences`` from ``mrgan_tpu/data/preprocess.py``
(processdata.py:41-85 semantics):

- force/pressure/temperature windows: [impact-0.1 s, impact+duration], the
  post index clamping to the stream end, resampled to 100*duration points
  on a linspace between the window's first and last sample times;
- force taxels 3 and 4; temperature Celsius channel [:, 1];
- contact mic: impact +/- duration/2 with the reference's off-by-one grid
  start, resampled to 48000*duration points.

Ragged streams are padded on the host and each stream's pokes run as one
batched gather+lerp on ``device`` (ops.resample), in float32 like the JAX
package. The offline ``run`` over raw pickle directories is not ported yet.
"""

import numpy as np
import torch

from ..ops import resample

TAXEL_1, TAXEL_2 = 3, 4  # processdata.py:51-53


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
