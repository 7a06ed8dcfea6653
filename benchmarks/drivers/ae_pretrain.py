"""Autoencoder pretraining of the AE-GAN (mr_gan_autoencoder.py:296-313) on
raw contact-mic windows.

Set-up makes the set on the card and prepares each stratified fold's pool
(its train rows, scaled by a scaler fit on them) as
``variants/autoencoder.py::run_ae_gan_cell`` prepares it, once. The window
calls ``variants/autoencoder.py::train_autoencoder`` on the fold-stacked
pools again and again, each call a fresh training of ``epochs`` epochs;
a call ends synchronised. Set-up runs one call, which warms every shape.

The window's first call runs with the benchmark's weights and first-epoch
permutation handed to the program (through the hooks ``HOOKS`` of
``mrgan_tpu_torch.variants.autoencoder``, wrapped for that call) and
records the first ``check_steps`` steps, as the GAN cell does; ``check``
recomputes them with the plain reference from the seed after the window.
"""

import numpy as np
import torch

import checks
import inputs
from reference import folds as ref_folds
from reference import nets as ref
from yardstick import ae_fold_step_flops

HOOKS = ("ae_init", "ae_draw_epoch", "ae_train_step")


class Cell:
    unit = "fold-steps"

    def __init__(self, cfg, mix, seed, device):
        from mrgan_tpu_torch.train import gan, protocol
        from mrgan_tpu_torch.utils import device as device_lib
        from mrgan_tpu_torch.utils import rng as rng_util
        from mrgan_tpu_torch.variants import autoencoder

        device_lib.set_fp32_policy()
        self.cfg, self.mix, self.device = cfg, mix, torch.device(device)
        keys = ("data", "weights", "perm", "program", "protocol")
        self.seeds = dict(zip(keys, inputs.sub_seeds(seed, len(keys))))
        self.protocol_seed = self.seeds["protocol"] % 2**32
        x, y = inputs.ae_data(cfg, self.seeds["data"], self.device)
        ds = protocol.DeviceDataset(x, y, device=self.device)
        splits = protocol.stratified_splits(ds.y_host, n_splits=mix["folds"],
                                            seed=self.protocol_seed)
        train = gan.index_tensor(np.stack([tr for tr, _ in splits]),
                                 self.device)
        self.pool = gan.scaled_rows(ds.X, train, train)[0]
        del ds, x, train
        self.acfg = autoencoder.AeConfig(
            nodes=tuple(cfg["encoder"]), epochs=mix["epochs"],
            batch_size=cfg["batch_size"], lr=cfg["lr"])
        self.generator = rng_util.make_generator(self.seeds["program"] % 2**63,
                                                 self.device)
        n_folds, n, _ = self.pool.shape
        bs, nb = autoencoder.ae_batches(n, self.acfg)
        self.shape = (n_folds, n, bs, nb)
        self.steps_per_call = mix["epochs"] * nb
        self.fold_steps = n_folds * self.steps_per_call
        self.flops_per_unit = ae_fold_step_flops(cfg)
        self.failed = 0
        self.reading = None
        self._handed = (inputs.ae_weights(cfg, n_folds, self.seeds["weights"],
                                          self.device), self._perm())
        checks.warm_reading(inputs.flat(self._handed[0]), n_folds)
        self._launch()

    def call(self):
        """One call of the window; the first records the checked steps."""
        if self.reading is None:
            self.reading = self._capture()
        else:
            self._launch()
        return self.fold_steps

    def _launch(self):
        from mrgan_tpu_torch.variants import autoencoder

        params = autoencoder.train_autoencoder(self.generator, self.pool,
                                               self.acfg)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.failed += int(not bool(torch.isfinite(
            params["dec"][-1]["b"]).all()))

    def trace_segment(self):
        self.call()
        return self.steps_per_call

    def spans(self):
        return {}

    def _perm(self):
        n_folds, n, bs, _ = self.shape
        return inputs.schedule(inputs.generator(self.seeds["perm"],
                                                self.device),
                               n_folds, n, n, bs, self.device)

    def _capture(self):
        from mrgan_tpu_torch.variants import autoencoder as ae

        cfg, n_folds = self.cfg, self.shape[0]
        init, perm = self._handed
        self._handed = None
        init_flat = inputs.flat(init)
        n_check, b1 = self.mix["check_steps"], cfg["beta1"]
        seen = {"init": False, "perm": False, "steps": 0}
        reading = {"loss": [], "grad": None, "change": None}
        orig = {n: getattr(ae, n) for n in HOOKS}

        def ae_init(generator, in_dim, nodes, folds, device=None):
            if seen["init"]:
                return orig["ae_init"](generator, in_dim, nodes, folds, device)
            seen["init"] = True
            return init

        def ae_draw_epoch(*args, **kwargs):
            if seen["perm"]:
                return orig["ae_draw_epoch"](*args, **kwargs)
            seen["perm"] = True
            return perm

        def ae_train_step(state, xb, acfg):
            new, loss = orig["ae_train_step"](state, xb, acfg)
            seen["steps"] += 1
            k = seen["steps"]
            if k <= n_check:
                reading["loss"].append(loss.double()[None])
            if k == 1:
                reading["grad"] = checks.norms(inputs.flat(new["opt"]["m"]),
                                               n_folds, 1.0 / (1.0 - b1))
            if k == n_check:
                reading["change"] = checks.norms(
                    {n: t - init_flat[n]
                     for n, t in inputs.flat(new["params"]).items()}, n_folds)
            return new, loss

        wrappers = {"ae_init": ae_init, "ae_draw_epoch": ae_draw_epoch,
                    "ae_train_step": ae_train_step}
        try:
            for n, fn in wrappers.items():
                setattr(ae, n, fn)
            self._launch()
        finally:
            for n, fn in orig.items():
                setattr(ae, n, fn)
        checks.hooks_fired(ae.__name__, {
            "ae_init": seen["init"], "ae_draw_epoch": seen["perm"],
            "ae_train_step": seen["steps"] >= n_check})
        reading["loss"] = torch.stack(reading["loss"])
        return checks.to_host(reading)

    def reference(self, tf32=False, half_batch=False):
        """The plain reference's reading of the first steps, from the seed
        alone; ``half_batch`` plants the fault of a step that leaves half
        of its batch out."""
        cfg, dev = self.cfg, self.device
        n_folds = self.shape[0]
        x, y = inputs.ae_data(cfg, self.seeds["data"], dev)
        splits = ref_folds.stratified_splits(y.cpu().numpy(),
                                             self.mix["folds"],
                                             self.protocol_seed)
        train = torch.as_tensor(np.stack([tr for tr, _ in splits]),
                                device=dev)
        init = inputs.flat(inputs.ae_weights(cfg, n_folds,
                                             self.seeds["weights"], dev))
        perm = self._perm()
        depth = len(cfg["encoder"])
        state = ref.init_state(init, torch.float32)
        out = {"loss": []}
        ref.allow_tf32(tf32)
        try:
            mean, std = ref.scaler_fit(x[train])
            for k in range(self.mix["check_steps"]):
                rows = torch.gather(train, 1, perm[:, k])
                xb = (x[rows] - mean[:, None]) / std[:, None]
                if half_batch:
                    xb = xb[:, :xb.shape[1] // 2]
                state, loss = ref.ae_step(state, xb, depth, lr=cfg["lr"],
                                          b1=cfg["beta1"])
                out["loss"].append(loss.double().cpu()[None])
                if k == 0:
                    out["grad"] = checks.norms(state["m"], n_folds,
                                               1.0 / (1.0 - cfg["beta1"]))
            out["change"] = checks.norms(
                {n: state["p"][n] - init[n] for n in init}, n_folds)
        finally:
            ref.allow_tf32(False)
        out["loss"] = torch.stack(out["loss"])
        return checks.to_host(out)

    def check(self, limits):
        self.pool = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        numbers = checks.training_numbers(self.reading, self.reference())
        return checks.against_limits(numbers, limits)
