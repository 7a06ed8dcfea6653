"""Material-classifier serving: load a snapshot, classify pokes.

Port of ``mrgan_tpu/serve.py``. The artifact packages the semi-supervised
GAN's discriminator (its 6-way head is the material classifier) with the
StandardScaler statistics and the modality/frontend configuration:

    clf = MaterialClassifier.load("clf.pkl", device="cuda")
    names = clf.classify(features)                 # -> material names
    names = clf.classify_pokes(temperature=..., force0=..., force1=...,
                               contact=...)       # raw windows -> frontend
    name = clf.classify_raw_poke(raw)              # one raw poke, online

Snapshots use the JAX package's pickled-numpy schema, so a classifier
trained by ``fit_classifier`` of ``mrgan_tpu/serve.py`` and saved as ``.pkl`` serves
here (``from_jax_blob`` for a blob already in memory), and one trained here
by :func:`fit_classifier` serves there.
"""

import numpy as np
import torch

from . import MATERIALS
from .data.preprocess import ShortWindowError  # noqa: F401 (re-exported)
from .models import nets
from .ops import features as feat_ops
from .train import gan, protocol
from .utils import params_io
from .utils import rng as rng_util


class MaterialClassifier:
    def __init__(self, disc, mean, inv_std, modality=None,
                 materials=MATERIALS, valid_dim=None, ft_time=4.0,
                 c_time=0.2, *, device):
        self.device = torch.device(device)
        self.disc = disc.to(self.device).eval()
        self.mean = torch.as_tensor(mean, dtype=torch.float32,
                                    device=self.device)
        self.inv_std = torch.as_tensor(inv_std, dtype=torch.float32,
                                       device=self.device)
        self.modality = modality
        self.materials = tuple(materials)
        self.valid_dim = valid_dim if valid_dim is not None else len(self.mean)
        # impact-window durations the training features were resampled to
        # (processdata.py's duration/contactAccelLength); classify_raw_poke
        # windows live sensor streams with the same config
        self.ft_time = float(ft_time)
        self.c_time = float(c_time)

    def _tensor(self, x):
        return None if x is None else torch.as_tensor(
            x, dtype=torch.float32, device=self.device)

    # -- inference -----------------------------------------------------------

    def _prep(self, x):
        x = self._tensor(x)
        d = self.mean.shape[0]
        if x.shape[-1] < d:  # pad to the training-time width
            x = torch.nn.functional.pad(x, (0, d - x.shape[-1]))
        return (x - self.mean) * self.inv_std

    @torch.inference_mode()
    def predict_logits(self, x):
        """(B, D') features -> (B, num_classes) logits on the device."""
        logits, _ = self.disc(self._prep(x))
        return logits

    def predict_proba(self, x):
        return torch.softmax(self.predict_logits(x), dim=-1)

    def predict(self, x):
        return self.predict_logits(x).argmax(dim=-1)

    def classify(self, x):
        return [self.materials[i] for i in self.predict(x).tolist()]

    @torch.inference_mode()
    def classify_pokes(self, temperature=None, force0=None, force1=None,
                       contact=None):
        """Raw resampled windows -> frontend -> material names."""
        feats = feat_ops.assemble(
            self.modality, temperature=self._tensor(temperature),
            force0=self._tensor(force0), force1=self._tensor(force1),
            contact=self._tensor(contact))
        return self.classify(feats)

    def classify_raw_poke(self, raw, index=-1):
        """Online robot-side inference: one poke straight from the collection
        stack's save schema (collectdataPoke.py's dataAll batch dict) ->
        impact windowing + lerp resampling at the classifier's trained
        durations (processdata.py:56-83 semantics) -> frontend -> material
        name. A poke with a stream that holds no samples raises
        ``ShortWindowError``, a ``ValueError``."""
        from .data import preprocess

        # window only the streams this modality's frontend reads — the
        # 48 kHz contact resample dominates
        streams = {"force", "temperature", "contact"} if self.modality is \
            None else set(feat_ops.MODALITY_STREAMS[self.modality])
        keys = ["collisionTime"]
        if "force" in streams:
            keys += ["RGripRFingerTime", "RGripRFingerForce"]
        if "temperature" in streams:
            keys += ["temperatureTime", "temperatureRaw"]
        if "contact" in streams:
            keys += ["contactmicTime", "contactmic"]
        one = {key: [raw[key][index]] for key in keys}
        w = preprocess.process_sequences(one, self.ft_time, self.c_time,
                                         streams=streams, device=self.device)

        def arr(name):
            return np.asarray(w[name], np.float32) if name in w else None

        return self.classify_pokes(
            temperature=arr("temperature"), force0=arr("force0"),
            force1=arr("force1"), contact=arr("contact"))[0]

    # -- persistence ----------------------------------------------------------

    def save(self, path):
        """Write the JAX package's blob schema as a pickle; returns the path."""
        return params_io.save(path, {
            "disc": nets.discriminator_to_jax(self.disc),
            "mean": self.mean,
            "inv_std": self.inv_std,
            "modality": np.int32(-1 if self.modality is None else
                                 self.modality),
            "valid_dim": np.int32(self.valid_dim),
            "ft_time": np.float64(self.ft_time),
            "c_time": np.float64(self.c_time),
        })

    @classmethod
    def from_jax_blob(cls, blob, device):
        """A classifier from the JAX package's blob dict (numpy leaves)."""
        modality = int(blob["modality"])
        return cls(nets.discriminator_from_jax(blob["disc"]), blob["mean"],
                   blob["inv_std"], None if modality < 0 else modality,
                   valid_dim=int(blob["valid_dim"]),
                   ft_time=float(blob.get("ft_time", 4.0)),
                   c_time=float(blob.get("c_time", 0.2)), device=device)

    @classmethod
    def load(cls, path, device):
        return cls.from_jax_blob(params_io.restore(path), device)


def fit_classifier(x, y, modality=None, percentlabeled=100, cfg=None, seed=0,
                   ft_time=4.0, c_time=0.2, *, device):
    """Train the semi-supervised GAN on all of (x, y) and return a
    deployable classifier on ``device`` (port of ``mrgan_tpu/serve.py:142-171``):
    scaler stats fit on the whole set, like a final production fit; the
    labeled rows are the first 10 * percentlabeled of each class after one
    seeded shuffle, every row is in the unlabeled pool, and the trainer's
    generator is seeded with ``seed``."""
    cfg = gan.GanConfig() if cfg is None else cfg
    device = torch.device(device)
    rng = np.random.RandomState(seed)
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    y = torch.as_tensor(y, device=device).to(torch.int64)
    xp, valid_dim = gan.pad_features(x, cfg.pad_multiple)
    mean, inv = gan.scale_stats(xp)
    xs = (xp - mean) * inv
    rows = np.arange(len(xs))
    lab, pool, _, _ = protocol.fold_indices(
        y.cpu().numpy(), rows, rows[:1], percentlabeled, None,
        cfg.num_classes, rng)
    lab, pool = (torch.as_tensor(a.astype(np.int64), device=device)
                 for a in (lab, pool))
    _, aux = gan.train_folds(
        rng_util.make_generator(seed, device), xs[lab][None], y[lab][None],
        xs[pool][None], xs[:1][None], y[:1][None],  # a dummy test row
        n_train=len(xs), valid_dim=valid_dim, cfg=cfg)
    disc = gan.params_to_jax(aux["params"])["disc"]
    disc = {k: {n: a[0] for n, a in v.items()} for k, v in disc.items()}
    return MaterialClassifier(nets.discriminator_from_jax(disc), mean, inv,
                              modality, valid_dim=valid_dim, ft_time=ft_time,
                              c_time=c_time, device=device)
