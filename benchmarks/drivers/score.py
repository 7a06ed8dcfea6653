"""Offline scoring of recorded collections through the material classifier.

A closed loop with one client: each request hands
``serve.py::MaterialClassifier.classify_pokes`` a whole collected set
(temperature, two fingertip forces and the contact-mic window of every
poke) and ends when the material names are back on the host. Set-up makes
``sets`` collections on the card from the seed, the discriminator's
weights and the deployed scaler, builds the classifier and serves each
set once; the window cycles through the sets in a seeded order.

The check draws ``check_requests`` of the window's finished requests from
the seed and holds every answer to the plain reference's logits of its
poke (log-mel, assembly, scaling, discriminator), computed after the
window.
"""

import numpy as np
import torch

import checks
import inputs
from reference import mel as ref_mel
from reference import nets as ref
from yardstick import mel_bound, score_poke_flops

STREAMS = ("temperature", "force0", "force1")


class Cell:
    unit = "pokes"

    def __init__(self, cfg, mix, seed, device):
        from mrgan_tpu_torch import serve
        from mrgan_tpu_torch.models import nets
        from mrgan_tpu_torch.utils import device as device_lib

        device_lib.set_fp32_policy()
        self.cfg, self.mix, self.device = cfg, mix, torch.device(device)
        keys = ("weights", "sets", "order", "sample")
        self.seeds = dict(zip(keys, inputs.sub_seeds(seed, len(keys))))
        self.pokes = mix["pokes"]
        self.sets = self._sets()
        weights = inputs.classifier_weights(cfg, self.seeds["weights"],
                                            self.device)
        self.mean, self.std = self._scaler()
        disc = nets.Discriminator(
            cfg["features"], cfg["num_classes"],
            widths=tuple(cfg["disc_trunk"]), mid_width=cfg["disc_mid"],
            generator=torch.Generator(device=self.device),
            device=self.device)
        with torch.no_grad():
            for name, p in weights.items():
                getattr(disc, name).weight.copy_(p["w"].T)
                getattr(disc, name).bias.copy_(p["b"])
        self.clf = serve.MaterialClassifier(
            disc, self.mean, 1.0 / self.std, modality=cfg["modality"],
            device=self.device)
        self.materials = self.clf.materials
        self._order = np.random.RandomState(self.seeds["order"] % 2**32)
        self.answers = []
        self.flops_per_unit = score_poke_flops(cfg)
        self.failed = 0
        for k in range(len(self.sets)):
            self.clf.classify_pokes(**self.sets[k])

    def _sets(self):
        seeds = inputs.sub_seeds(self.seeds["sets"], self.mix["sets"])
        return [inputs.poke_windows(self.cfg, self.pokes, s, self.device)
                for s in seeds]

    def _features(self, s, logmel, rows):
        return torch.cat([s[n][rows] for n in STREAMS]
                         + [logmel(s["contact"][rows])], dim=-1)

    def _scaler(self):
        """The deployed scaler: mean and std of every feature over the
        first set, its log-mel by the plain reference (the benchmark's
        own statistics, made before the program runs)."""
        feats = self._features(self.sets[0], ref_mel.LogMel(self.device),
                               slice(None))
        return ref.scaler_fit(feats)

    def call(self):
        k = int(self._order.randint(len(self.sets)))
        names = self.clf.classify_pokes(**self.sets[k])
        self.answers.append((k, names))
        self.failed += int(len(names) != self.pokes)
        return self.pokes

    def trace_segment(self):
        n = self.mix["trace_requests"]
        for _ in range(n):
            self.call()
        return n

    def spans(self):
        """The device time of the frontend (``ops/mel.py::frontend_logmel``)
        on one request's audio, by CUDA events over ``span_repeats``
        calls, and the frozen bound of that work."""
        from mrgan_tpu_torch.ops import mel

        audio = self.sets[0]["contact"]
        if self.device.type != "cuda":
            return {}
        reps = self.mix["span_repeats"]
        mel.frontend_logmel(audio)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            mel.frontend_logmel(audio)
        end.record()
        torch.cuda.synchronize()
        frames = self.pokes * ref_mel.n_frames(self.cfg["audio_len"])
        bound_s, _ = mel_bound(self.pokes,
                               self.cfg["audio_len"] + ref_mel.N_FFT, frames)
        return {"frontend_s": start.elapsed_time(end) / 1e3 / reps,
                "frontend_bound_s": bound_s}

    # -- the check -----------------------------------------------------------

    def sample(self):
        """The checked requests: ``check_requests`` of the finished ones,
        drawn from the seed."""
        rng = np.random.RandomState(self.seeds["sample"] % 2**32)
        n = len(self.answers)
        return sorted(rng.choice(n, min(n, self.mix["check_requests"]),
                                 replace=False))

    def reference_logits(self, k, tf32=False):
        """The plain reference's (pokes, classes) logits of set ``k``."""
        trunk = len(self.cfg["disc_trunk"])
        weights = inputs.classifier_weights(self.cfg, self.seeds["weights"],
                                            self.device)
        p = {"disc.%s.%s" % (n, w): t[None] for n, d in weights.items()
             for w, t in d.items()}
        s = inputs.poke_windows(
            self.cfg, self.pokes,
            inputs.sub_seeds(self.seeds["sets"], self.mix["sets"])[k],
            self.device)
        ref.allow_tf32(tf32)
        try:
            f = self._features(s, ref_mel.LogMel(self.device), slice(None))
            logits, _ = ref.discriminator(
                p, ((f - self.mean) / self.std)[None], trunk)
        finally:
            ref.allow_tf32(False)
        return logits[0].double().cpu()

    def served(self, names):
        index = {m: i for i, m in enumerate(self.materials)}
        return torch.tensor([index.get(n, -1) for n in names],
                            dtype=torch.int64)

    def numbers(self, picks):
        """The widest answer gap over the requests ``picks``."""
        refs, gap = {}, 0.0
        for i in picks:
            k, names = self.answers[i]
            if k not in refs:
                refs[k] = self.reference_logits(k)
            gap = max(gap, checks.answer_gap(refs[k], self.served(names)))
        return {"answer_gap": gap}

    def check(self, limits):
        picks = self.sample()
        self.clf = self.sets = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return checks.against_limits(self.numbers(picks), limits)
