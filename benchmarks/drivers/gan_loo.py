"""Leave-one-object-out GAN training (Table 3's protocol, mr_gan.py:263-283).

The window calls ``train/protocol.py::run_gan_loo`` again and again on the
collected set, every held-out object a fold of one launch of ``chunk``
folds; a call ends with the folds' test errors on the host. Set-up makes
the set on the card and runs one call, which warms every shape the window
uses.

The window's first call runs with the benchmark's weights, first-epoch
batch schedule and first steps' Gaussian draws handed to the program in
place of its own draws (through the hooks ``HOOKS`` of
``mrgan_tpu_torch.train.gan``, wrapped for that call), and records the
first ``check_steps`` steps' losses, the first gradients as the optimizer
holds them and every leaf's change. ``check`` recomputes the same steps
with the plain reference, from the seed, after the window.
"""

import numpy as np
import torch

import checks
import inputs
from reference import folds as ref_folds
from reference import nets as ref
from yardstick import gan_fold_step_flops

HOOKS = ("init_params", "epoch_schedule", "draw_step", "train_step")


class Cell:
    unit = "fold-steps"

    def __init__(self, cfg, mix, seed, device):
        from mrgan_tpu_torch.train import gan
        from mrgan_tpu_torch.utils import device as device_lib

        device_lib.set_fp32_policy()
        self.cfg, self.mix, self.device = cfg, mix, torch.device(device)
        keys = ("data", "weights", "sched", "draws", "protocol")
        self.seeds = dict(zip(keys, inputs.sub_seeds(seed, len(keys))))
        self.protocol_seed = self.seeds["protocol"] % 2**32
        x, y, self.offsets = inputs.loo_data(cfg, self.seeds["data"],
                                             self.device)
        self.y_host = y.cpu().numpy()
        self.objects = {"obj%02d" % i: {"x": x[a:b], "y": y[a:b]}
                        for i, (a, b) in enumerate(zip(self.offsets[:-1],
                                                       self.offsets[1:]))}
        n_obj = len(self.objects)
        self.n_train = len(y) - cfg["pokes_per_object"]
        self.n_folds = min(mix["chunk"], n_obj)
        self.gcfg = gan.GanConfig(
            epochs=mix["epochs"], batch_size=cfg["batch_size"],
            noise_size=cfg["noise_size"], lr=cfg["lr"], beta1=cfg["beta1"],
            num_classes=cfg["num_classes"],
            opt_state_dtype=cfg["moment_dtype"])
        self.steps_per_call = mix["epochs"] * (self.n_train
                                               // cfg["batch_size"])
        self.fold_steps = n_obj * self.steps_per_call
        self.flops_per_unit = gan_fold_step_flops(cfg)
        self.failed = 0
        self.reading = None
        self._handed = self._handed_inputs()
        checks.warm_reading(inputs.flat(self._handed[0]), self.n_folds)
        self._launch()

    def call(self):
        """One call of the window; the first records the checked steps."""
        if self.reading is None:
            self.reading = self._capture()
        else:
            self._launch()
        return self.fold_steps

    def _launch(self):
        from mrgan_tpu_torch.train import protocol

        _, errors = protocol.run_gan_loo(
            self.objects, self.mix["percent_labeled"], cfg=self.gcfg,
            seed=self.protocol_seed, chunk=self.mix["chunk"],
            device=self.device)
        self.failed += int(not np.all(np.isfinite(errors)))

    def trace_segment(self):
        self.call()
        return self.steps_per_call * -(-len(self.objects) // self.n_folds)

    def spans(self):
        return {}

    # -- the first steps, for the check ------------------------------------

    def _first_inputs(self):
        """The benchmark's weights, first-epoch schedule and first steps'
        draws for the first launch's folds."""
        cfg, f, dev = self.cfg, self.n_folds, self.device
        rows = ref_folds.loo_rows(self.y_host, self.offsets,
                                  self.mix["percent_labeled"],
                                  cfg["num_classes"], self.protocol_seed)
        n_lab = len(rows[0][0])
        g = inputs.generator(self.seeds["sched"], dev)
        sched = tuple(inputs.schedule(g, f, n, self.n_train,
                                      cfg["batch_size"], dev)
                      for n in (n_lab, self.n_train, self.n_train))
        draw_seeds = inputs.sub_seeds(self.seeds["draws"],
                                      self.mix["check_steps"])
        return rows[:f], sched, draw_seeds

    def _handed_inputs(self):
        """What the checked call hands the program, made in set-up: the
        weights, the first epoch's schedule and the first steps' draws."""
        cfg, f, dev = self.cfg, self.n_folds, self.device
        _, sched, draw_seeds = self._first_inputs()
        return (inputs.gan_weights(cfg, f, self.seeds["weights"], dev), sched,
                [inputs.gan_draws(cfg, f, s, dev) for s in draw_seeds])

    def _capture(self):
        from mrgan_tpu_torch.train import gan

        cfg, f = self.cfg, self.n_folds
        init, sched, draws = self._handed
        self._handed = None
        init_flat = inputs.flat(init)
        n_check = self.mix["check_steps"]
        b1 = cfg["beta1"]
        seen = {"init": False, "sched": False, "draws": 0, "steps": 0}
        reading = {"loss": [], "grad": None, "change": None}
        orig = {n: getattr(gan, n) for n in HOOKS}

        def init_params(generator, feat_dim, gcfg, n_folds):
            if seen["init"]:
                return orig["init_params"](generator, feat_dim, gcfg, n_folds)
            seen["init"] = True
            if n_folds != f or feat_dim != cfg["features"]:
                raise ValueError("launch of %d folds x %d features, the "
                                 "benchmark made %d x %d"
                                 % (n_folds, feat_dim, f, cfg["features"]))
            return init

        def epoch_schedule(*args, **kwargs):
            if seen["sched"]:
                return orig["epoch_schedule"](*args, **kwargs)
            seen["sched"] = True
            return sched

        def draw_step(*args, **kwargs):
            if seen["draws"] >= n_check:
                return orig["draw_step"](*args, **kwargs)
            seen["draws"] += 1
            return draws[seen["draws"] - 1]

        def train_step(state, *args, **kwargs):
            new, out = orig["train_step"](state, *args, **kwargs)
            seen["steps"] += 1
            k = seen["steps"]
            if k <= n_check:
                reading["loss"].append(torch.stack(out[:2]).double())
            if k == 1:
                m = inputs.flat({"disc": new["opt_d"]["m"],
                                 "gen": new["opt_g"]["m"]})
                reading["grad"] = checks.norms(m, f, 1.0 / (1.0 - b1))
            if k == n_check:
                reading["change"] = checks.norms(
                    {n: t - init_flat[n] for n, t in inputs.flat(
                        {"disc": new["disc"], "gen": new["gen"]}).items()},
                    f)
            return new, out

        wrappers = {"init_params": init_params,
                    "epoch_schedule": epoch_schedule,
                    "draw_step": draw_step, "train_step": train_step}
        try:
            for n, fn in wrappers.items():
                setattr(gan, n, fn)
            self._launch()
        finally:
            for n, fn in orig.items():
                setattr(gan, n, fn)
        checks.hooks_fired(gan.__name__, {
            "init_params": seen["init"], "epoch_schedule": seen["sched"],
            "draw_step": seen["draws"] == n_check,
            "train_step": seen["steps"] >= n_check})
        reading["loss"] = torch.stack(reading["loss"])
        return checks.to_host(reading)

    # -- the check -----------------------------------------------------------

    def reference(self, tf32=False, half_batch=False):
        """The plain reference's reading of the first launch's first steps,
        from the seed alone. ``half_batch``: a planted fault (each batch's
        first half only), for the control's readings."""
        cfg, f, dev = self.cfg, self.n_folds, self.device
        x, y, _ = inputs.loo_data(cfg, self.seeds["data"], dev)
        rows, sched, draw_seeds = self._first_inputs()
        init = inputs.flat(inputs.gan_weights(cfg, f, self.seeds["weights"],
                                              dev))
        draws = [inputs.gan_draws(cfg, f, s, dev) for s in draw_seeds]
        lab, pool, train = (torch.as_tensor(np.stack([r[j] for r in rows]),
                                            device=dev) for j in range(3))
        state = ref.init_state(init, getattr(torch, cfg["moment_dtype"]))
        trunk = len(cfg["disc_trunk"])
        out = {"loss": []}
        ref.allow_tf32(tf32)
        try:
            mean, std = ref.scaler_fit(x[train])

            def rows_of(positions, table, k):
                r = torch.gather(table, 1, positions[:, k])
                return r, (x[r] - mean[:, None]) / std[:, None]

            for k, d in enumerate(draws):
                r_lab, xl = rows_of(sched[0], lab, k)
                _, xu = rows_of(sched[1], pool, k)
                _, xu2 = rows_of(sched[2], pool, k)
                yl = y[r_lab]
                if half_batch:
                    xl, yl, xu, xu2, d = _half(xl, yl, xu, xu2, d)
                state, (ll, lu) = ref.gan_step(
                    state, xl, yl, xu, xu2, d, trunk, lr=cfg["lr"],
                    b1=cfg["beta1"])
                out["loss"].append(torch.stack([ll, lu]).double().cpu())
                if k == 0:
                    out["grad"] = checks.norms(state["m"], f,
                                               1.0 / (1.0 - cfg["beta1"]))
            out["change"] = checks.norms(
                {n: state["p"][n] - init[n] for n in init}, f)
        finally:
            ref.allow_tf32(False)
        out["loss"] = torch.stack(out["loss"])
        return checks.to_host(out)

    def check(self, limits):
        self.objects = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        numbers = checks.training_numbers(self.reading, self.reference())
        return checks.against_limits(numbers, limits)


def _half(xl, yl, xu, xu2, d):
    """Each batch's first half, the generator's draws and the noise cut to
    match (the fault of a step that leaves half of its batch out)."""
    h = xl.shape[1] // 2

    def noise(ts, parts):
        return [torch.cat([t.chunk(parts, 1)[i][:, :h] for i in range(parts)],
                          1) for t in ts]

    return (xl[:, :h], yl[:, :h], xu[:, :h], xu2[:, :h],
            {"z1": d["z1"][:, :h], "z2": d["z2"][:, :h],
             "noise_d": noise(d["noise_d"], 3),
             "noise_g": noise(d["noise_g"], 2)})
