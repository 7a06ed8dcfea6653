"""SCiO/Lumini spectrometer dataset utilities (others/util.py).

Port of ``mrgan_tpu/data/spectrometer.py``, a copy of its numpy code: the
WGAN-LP-CT grid search also runs on a handheld-spectrometer dataset; the
reference's loader parses per-measurement text files (material/object
directory layout, original + sensitivity-corrected spectra split by a
'sensitivity' marker line) and caps samples per object. The synthetic
generators and the loaders are the JAX package's, bit for bit (the CPU
tests pin them); ``first_deriv`` runs the port's ``ops.resample.first_deriv``
in float32 on CPU tensors.
"""

import glob
import os

import numpy as np
import torch

from .. import MATERIALS
from ..ops import resample


def load_lumini_dataset(data_dir=os.path.join("data", "lumini")):
    """util.py:4-26: returns (rows, wavelengths) where each row is
    [material, object, exposure, *orig_values, *corrected_values]."""
    data = []
    wavelengths = None
    filenames = sorted(glob.glob(os.path.join(data_dir, "*", "*", "*_*_*.txt")))
    for filename in filenames:
        parts = filename.split(os.sep)
        material, object_name = parts[-3], parts[-2]
        exposure = int(parts[-1].split(".")[0].split("_")[-1])
        with open(filename) as f:
            lines = f.read().splitlines()
        split = next(
            (i for i, l in enumerate(lines) if "sensitivity" in l), 0
        )
        orig = np.array([l.split("\t") for l in lines[1:split]], np.float64)
        corrected = np.array([l.split("\t") for l in lines[split + 1 :]],
                             np.float64)
        if wavelengths is None:
            wavelengths = orig[:, 0]
        elif not (np.array_equal(wavelengths, orig[:, 0])
                  and np.array_equal(wavelengths, corrected[:, 0])):
            raise ValueError(
                f"Found a file with inconsistent wavelengths: {filename}"
            )
        data.append([material, object_name, exposure]
                    + orig[:, 1].tolist() + corrected[:, 1].tolist())
    return data, wavelengths


def _half_slice(values, corrected, reference_quirk):
    """Select the original or sensitivity-corrected half of a loaded row
    ([*orig, *corrected], see load_lumini_dataset).

    ``reference_quirk=True`` reproduces the reference's inverted slice
    verbatim: its processLuminiDataset (util.py:40-46) takes values[:half]
    for correctedValues=True, which against its own loader's row layout is
    the ORIGINAL block. Pinned by tests for C9 parity. New APIs
    (lumini_objects) pass False and get the genuinely corrected half.
    """
    half = len(values) // 2
    first = corrected if reference_quirk else not corrected
    return values[:half] if first else values[half:]


def _iter_rows(data, materials, exposure, sample_count):
    """Shared filter/cap core: yield (material_index, object, values) for
    rows matching the material list and exposure, capping samples per
    object (util.py:33-53 semantics)."""
    counts = {}
    for d in data:
        material, obj, exp = d[0], d[1], d[2]
        if material not in materials or exp != exposure:
            continue
        key = material + obj
        if counts.get(key, 0) >= sample_count:
            continue
        counts[key] = counts.get(key, 0) + 1
        yield materials.index(material), obj, d[3:]


def _disambiguate_names(objects, materials):
    """Map {(material_index, obj): entry} to {display_name: entry}: plain
    object names normally, material-qualified only when the same name
    appears under more than one material (keys feed LOO protocols, where
    each key must be one physical object)."""
    name_counts = {}
    for _, obj in objects:
        name_counts[obj] = name_counts.get(obj, 0) + 1
    return {
        (obj if name_counts[obj] == 1 else f"{materials[index]}/{obj}"): e
        for (index, obj), e in objects.items()
    }


def process_lumini_dataset(data, material_names, object_names,
                           sample_count=20, exposure=100,
                           corrected_values=True):
    """util.py:28-54: filter by material/object/exposure, cap per-object
    samples, choose corrected or original spectra. Returns (X, y) lists.
    Preserves the reference's inverted half-slice (see _half_slice)."""
    X, y = [], []
    for index, obj, values in _iter_rows(data, material_names, exposure,
                                         sample_count):
        if obj not in object_names[index]:
            continue
        X.append(_half_slice(values, corrected_values, reference_quirk=True))
        y.append(index)
    return X, y


LUMINI_EXPOSURES = (100, 200, 300, 400, 500)  # wganlpctsemi.py:531 grid


def generate_lumini_dataset(out_dir, seed=0, materials=MATERIALS,
                            objects_per_material=6, samples_per_object=20,
                            exposures=LUMINI_EXPOSURES, n_wavelengths=331):
    """Write a synthetic handheld-spectrometer dataset in the exact on-disk
    layout ``load_lumini_dataset`` parses (util.py:4-26): per-measurement
    text files ``<material>/<object>/<object>_<i>_<exposure>.txt`` with a
    header line, tab-separated original spectra, a 'sensitivity' marker
    line, then the sensitivity-corrected spectra.

    The physics mirrors the synthetic-MREO design stance: material identity
    lives in a few reflectance bands (center/width/amplitude), per-object
    parameter jitter overlaps neighboring materials, and exposure sets the
    shot-noise SNR — so the reference's exposure/deriv/log grid dimensions
    (wganlpctsemi.py:531-562) have real signal to select on.
    """
    rng = np.random.RandomState(seed)
    wavelengths = np.linspace(340.0, 1000.0, n_wavelengths)
    # smooth instrument response; identical across every measurement
    sensitivity = (0.25 + np.exp(-(((wavelengths - 680.0) / 260.0) ** 2))
                   ) / 1.25
    # per-material reflectance bands (center nm, width nm, amplitude)
    bands = {
        "plastic": [(420, 60, 0.55), (780, 120, 0.35)],
        "glass": [(520, 200, 0.20), (940, 90, 0.30)],
        "fabric": [(470, 90, 0.45), (620, 70, 0.40), (860, 110, 0.25)],
        "metal": [(560, 300, 0.65)],
        "wood": [(500, 80, 0.35), (700, 100, 0.45)],
        "ceramic": [(450, 120, 0.50), (900, 140, 0.40)],
    }
    baselines = {"plastic": 0.25, "glass": 0.10, "fabric": 0.20,
                 "metal": 0.45, "wood": 0.30, "ceramic": 0.35}
    written = []
    for material in materials:
        for o in range(objects_per_material):
            obj = f"{material}obj{o}"
            obj_dir = os.path.join(out_dir, material, obj)
            os.makedirs(obj_dir, exist_ok=True)
            # per-object jitter: band centers drift, amplitudes rescale,
            # baseline tilts — objects of different materials overlap
            obj_bands = [(c + rng.normal(0, 18.0), w * rng.lognormal(0, 0.15),
                          a * rng.lognormal(0, 0.20))
                         for c, w, a in bands[material]]
            obj_base = baselines[material] * rng.lognormal(0, 0.15)
            obj_tilt = rng.normal(0, 8e-5)
            refl = obj_base + obj_tilt * (wavelengths - 670.0)
            for c, w, a in obj_bands:
                refl = refl + a * np.exp(-(((wavelengths - c) / w) ** 2))
            refl = np.clip(refl, 0.02, None)
            i = 0
            for exposure in exposures:
                for _ in range(samples_per_object):
                    gain = rng.lognormal(0, 0.03)
                    signal = exposure * refl * sensitivity * gain
                    noise = (rng.normal(size=signal.shape)
                             * (np.sqrt(signal) * 0.35 + 0.6))
                    orig = np.clip(signal + noise, 0.0, None)
                    corrected = orig / (exposure * sensitivity)
                    path = os.path.join(obj_dir, f"{obj}_{i}_{exposure}.txt")
                    with open(path, "w") as f:
                        f.write("wavelength\toriginal\n")
                        for wl, v in zip(wavelengths, orig):
                            f.write(f"{wl:.2f}\t{v:.6f}\n")
                        f.write("wavelength\tsensitivity corrected\n")
                        for wl, v in zip(wavelengths, corrected):
                            f.write(f"{wl:.2f}\t{v:.6f}\n")
                    written.append(path)
                    i += 1
    return written


def lumini_objects(data, materials=MATERIALS, sample_count=20, exposure=100,
                   corrected_values=True):
    """Group loaded rows into the per-object dict contract used by the
    generalization/LOO protocols ({name: {"x": (n,d), "y": (n,)}}), the
    spectrometer analog of the haptic loader's leaveObjectOut mode.

    Unlike process_lumini_dataset (which pins the reference's inverted
    half-slice), corrected_values=True here returns the genuinely
    sensitivity-corrected block — so the grid's exposure dimension varies
    SNR, not raw intensity scale."""
    objects = {}
    for index, obj, values in _iter_rows(data, materials, exposure,
                                         sample_count):
        values = _half_slice(values, corrected_values,
                             reference_quirk=False)
        # key on (material, object): same-named object dirs under two
        # materials are distinct objects, not one mislabeled merge
        entry = objects.setdefault((index, obj), {"x": [], "y": index})
        entry["x"].append(values)
    objects = _disambiguate_names(objects, materials)
    return {
        name: {"x": np.asarray(e["x"], np.float32),
               "y": np.full(len(e["x"]), e["y"], np.int32)}
        for name, e in objects.items()
    }


# --------------------------------------------------------------------------
# SCiO (NIR) dataset. The reference's grids sweep a SCiO dataset through
# util.loadScioDataset / processScioDataset (wganlpctsemi.py:661-677), but
# ships neither function — only the call-site semantics survive:
# spectrum_raw='spectrum' selects the processed spectrum, 'spectrum_raw'
# returns DOUBLE-width rows (processed + raw stacked) whose derivative is
# taken per half (preprocess doubleData, wganlpctsemi.py:677). The on-disk
# format here is therefore this framework's own: one CSV per measurement,
# header wavelength,spectrum,raw.
# --------------------------------------------------------------------------

SCIO_N_WAVELENGTHS = 331  # 740-1070 nm NIR band


def load_scio_dataset(data_dir=os.path.join("data", "scio")):
    """Returns (rows, wavelengths); each row is
    [material, object, *spectrum, *raw] (double-width values block)."""
    import csv

    data = []
    wavelengths = None
    for filename in sorted(glob.glob(
            os.path.join(data_dir, "*", "*", "*_*.csv"))):
        parts = filename.split(os.sep)
        material, object_name = parts[-3], parts[-2]
        with open(filename, newline="") as f:
            rows = list(csv.reader(f))[1:]  # skip header
        arr = np.asarray(rows, np.float64)
        if wavelengths is None:
            wavelengths = arr[:, 0]
        elif not np.array_equal(wavelengths, arr[:, 0]):
            raise ValueError(
                f"Found a file with inconsistent wavelengths: {filename}")
        data.append([material, object_name]
                    + arr[:, 1].tolist() + arr[:, 2].tolist())
    return data, wavelengths


def process_scio_dataset(data, material_names, object_names,
                         sample_count=100, spectrum_raw="spectrum"):
    """Call-site semantics of the reference's processScioDataset
    (wganlpctsemi.py:675-676): filter by material/object lists, cap samples
    per object; 'spectrum' -> processed block, 'spectrum_raw' -> the full
    double-width [processed, raw] row (deriv then runs per half)."""
    X, y, counts = [], [], {}
    for d in data:
        material, obj, values = d[0], d[1], d[2:]
        if material not in material_names:
            continue
        index = material_names.index(material)
        if obj not in object_names[index]:
            continue
        key = material + obj
        if counts.get(key, 0) >= sample_count:
            continue
        counts[key] = counts.get(key, 0) + 1
        X.append(values if spectrum_raw == "spectrum_raw"
                 else values[: len(values) // 2])
        y.append(index)
    return X, y


def scio_objects(data, materials=MATERIALS, sample_count=100,
                 spectrum_raw="spectrum"):
    """Per-object dict contract for the SCiO rows (cf. lumini_objects)."""
    objects = {}
    counts = {}
    for d in data:
        material, obj, values = d[0], d[1], d[2:]
        if material not in materials:
            continue
        index = materials.index(material)
        # cap and group per (material, object) — same-named object dirs
        # under two materials are distinct objects (cf. lumini_objects)
        if counts.get((index, obj), 0) >= sample_count:
            continue
        counts[(index, obj)] = counts.get((index, obj), 0) + 1
        vals = (values if spectrum_raw == "spectrum_raw"
                else values[: len(values) // 2])
        entry = objects.setdefault((index, obj), {"x": [], "y": index})
        entry["x"].append(vals)
    objects = _disambiguate_names(objects, materials)
    return {
        name: {"x": np.asarray(e["x"], np.float32),
               "y": np.full(len(e["x"]), e["y"], np.int32)}
        for name, e in objects.items()
    }


def generate_scio_dataset(out_dir, seed=0, materials=MATERIALS,
                          objects_per_material=6, samples_per_object=20,
                          n_wavelengths=SCIO_N_WAVELENGTHS):
    """Synthetic NIR spectrometer dataset in the load_scio_dataset format.

    NIR signatures live in overtone absorption bands; per-object jitter
    overlaps materials; raw = reflectance x sensor response + shot noise,
    spectrum = sensitivity-corrected raw (noisier than the lumini corrected
    block — NIR single-scan SNR is the realistic limiter)."""
    rng = np.random.RandomState(seed)
    wavelengths = np.linspace(740.0, 1070.0, n_wavelengths)
    response = (0.3 + np.exp(-(((wavelengths - 920.0) / 180.0) ** 2))) / 1.3
    bands = {
        "plastic": [(930, 35, 0.40), (1010, 45, 0.30)],
        "glass": [(950, 120, 0.15)],
        "fabric": [(860, 40, 0.35), (980, 50, 0.30)],
        "metal": [(900, 200, 0.55)],
        "wood": [(840, 50, 0.30), (970, 60, 0.35)],
        "ceramic": [(800, 60, 0.40), (1040, 50, 0.30)],
    }
    baselines = {"plastic": 0.35, "glass": 0.15, "fabric": 0.25,
                 "metal": 0.50, "wood": 0.30, "ceramic": 0.40}
    written = []
    for material in materials:
        for o in range(objects_per_material):
            obj = f"{material}obj{o}"
            obj_dir = os.path.join(out_dir, material, obj)
            os.makedirs(obj_dir, exist_ok=True)
            obj_bands = [(c + rng.normal(0, 12.0), w * rng.lognormal(0, 0.15),
                          a * rng.lognormal(0, 0.20))
                         for c, w, a in bands[material]]
            refl = (baselines[material] * rng.lognormal(0, 0.15)
                    + rng.normal(0, 6e-5) * (wavelengths - 900.0))
            for c, w, a in obj_bands:
                # absorption bands: dips in reflectance
                refl = refl - a * 0.4 * np.exp(
                    -(((wavelengths - c) / w) ** 2))
            refl = np.clip(refl + 0.3, 0.02, None)
            for i in range(samples_per_object):
                gain = rng.lognormal(0, 0.04)
                raw = 1000.0 * refl * response * gain
                raw = np.clip(
                    raw + rng.normal(size=raw.shape)
                    * (np.sqrt(np.abs(raw)) * 0.5 + 1.0), 0.0, None)
                spectrum = raw / (1000.0 * response)
                path = os.path.join(obj_dir, f"{obj}_{i}.csv")
                with open(path, "w") as f:
                    f.write("wavelength,spectrum,raw\n")
                    for wl, s, r in zip(wavelengths, spectrum, raw):
                        f.write(f"{wl:.2f},{s:.6f},{r:.4f}\n")
                written.append(path)
    return written


def first_deriv(x, wavelengths):
    """First derivative w.r.t. wavelength (util.py:56-64), vectorized over
    the batch, in float32 on the CPU."""
    x = torch.from_numpy(np.atleast_2d(np.asarray(x, np.float32)))
    w = torch.from_numpy(np.asarray(wavelengths, np.float32)).expand(x.shape)
    return resample.first_deriv(x, w).numpy()


def preprocess_spectra(X, y, wavelengths, uvir=None, deriv_log=None,
                       double_data=False):
    """wganlpctsemi.py:89-133 ``preprocess``: optional UV/IR band selection,
    then repeated log / first-derivative / (log+deriv+demean) transforms."""
    X = np.copy(np.asarray(X, np.float64))
    y = np.copy(np.asarray(y))
    wavelengths = np.copy(np.asarray(wavelengths, np.float64))

    if uvir == "uv":
        keep = wavelengths < 400
        X, wavelengths = X[:, keep], wavelengths[keep]
    elif uvir == "ir":
        keep = wavelengths > 700
        X, wavelengths = X[:, keep], wavelengths[keep]

    if deriv_log is None:
        return X, y, wavelengths

    def _deriv(x):
        if not double_data:
            return first_deriv(x, wavelengths)
        half = len(wavelengths)
        return np.concatenate(
            [first_deriv(x[:, :half], wavelengths),
             first_deriv(x[:, half:], wavelengths)], axis=-1)

    n = int(deriv_log[-1])
    if "log" in deriv_log:
        for _ in range(n):
            X = np.ma.log(X).filled(0)
    elif "preprocess" in deriv_log:
        for _ in range(n):
            X = np.ma.log(X).filled(0)
            X = _deriv(X)
            X -= np.mean(X, axis=-1, keepdims=True)
    elif "deriv" in deriv_log:
        for _ in range(n):
            X = _deriv(X)
    return X, y, wavelengths
