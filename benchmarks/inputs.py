"""Everything a run feeds the program and the reference, made on the device
from the run's seed: data sets, weights, the first steps' batch schedules
and Gaussian draws, and the scoring cell's sensor windows.

Each maker takes its own sub-seed (``sub_seeds``), so the reference can
make the same tensors again after the window without anything kept from
the program. Weights are drawn in one call per network and cut into
leaves; data in a few large calls.
"""

import math

import numpy as np
import torch


def sub_seeds(seed, n):
    """``n`` independent 63-bit seeds from a run's seed (any integer)."""
    state = np.random.SeedSequence(abs(int(seed))).generate_state(
        2 * n, dtype=np.uint32)
    return [int(state[2 * i]) << 31 ^ int(state[2 * i + 1]) for i in range(n)]


def generator(seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def _glorot_layers(seed, device, n_folds, layers):
    """Glorot-uniform (F, in, out) weights and zero (F, out) biases for
    every (in, out) of ``layers``, from one uniform draw."""
    sizes = [n_folds * i * o for i, o in layers]
    flat = torch.empty(sum(sizes), device=device).uniform_(
        -1.0, 1.0, generator=generator(seed, device))
    out = []
    for (i, o), w in zip(layers, flat.split(sizes)):
        w = w.view(n_folds, i, o).mul_(math.sqrt(6.0 / (i + o)))
        out.append({"w": w, "b": torch.zeros(n_folds, o, device=device)})
    return out


# --------------------------------------------------------------------------
# The GAN (fmgan_m5)
# --------------------------------------------------------------------------

def gan_weights(cfg, n_folds, seed, device):
    """{"gen": {"d1", "bn", "d2", "d3"}, "disc": {"d0".., "mid", "out"}},
    each dense {"w": (F, in, out), "b": (F, out)}: the program's layout."""
    from yardstick import disc_layers, gen_layers

    dl, gl = disc_layers(cfg), gen_layers(cfg)
    leaves = _glorot_layers(seed, device, n_folds, dl + gl)
    trunk = len(cfg["disc_trunk"])
    disc = {"d%d" % i: leaves[i] for i in range(trunk)}
    disc["mid"], disc["out"] = leaves[trunk], leaves[trunk + 1]
    g = leaves[len(dl):]
    h = cfg["gen_hidden"]
    bn = {"gamma": torch.ones(n_folds, h, device=device),
          "beta": torch.zeros(n_folds, h, device=device)}
    return {"gen": {"d1": g[0], "bn": bn, "d2": g[1], "d3": g[2]},
            "disc": disc}


def flat(tree, prefix=""):
    """A nested dict of tensors as {"a.b.c": tensor}."""
    out = {}
    for k, v in tree.items():
        name = prefix + str(k)
        if isinstance(v, dict):
            out.update(flat(v, name + "."))
        elif isinstance(v, list):
            out.update(flat(dict(enumerate(v)), name + "."))
        else:
            out[name] = v
    return out


def gan_draws(cfg, n_folds, seed, device):
    """One step's standard-normal draws in the program's layout: z1 and z2
    (F, b, noise), and the discriminator noise of the disc update (3b rows)
    and of the gen update (2b rows), one tensor per noised layer."""
    g = generator(seed, device)
    b, dims = cfg["batch_size"], (cfg["features"], *cfg["disc_trunk"])

    def normal(*shape):
        return torch.randn(shape, generator=g, device=device)

    return {"z1": normal(n_folds, b, cfg["noise_size"]),
            "noise_d": [normal(n_folds, 3 * b, d) for d in dims],
            "z2": normal(n_folds, b, cfg["noise_size"]),
            "noise_g": [normal(n_folds, 2 * b, d) for d in dims]}


def permutations(g, n_folds, n, device):
    keys = torch.randint(0, 2**62, (n_folds, n), generator=g, device=device)
    return keys.argsort(dim=-1)


def schedule(g, n_folds, n, n_out, batch, device):
    """(F, n_out // batch, batch) row positions in [0, n): permutations of
    range(n) laid end to end, so the rows of a batch, and of consecutive
    batches within one permutation, all differ."""
    reps = -(-n_out // n)
    perm = torch.cat([permutations(g, n_folds, n, device)
                      for _ in range(reps)], dim=-1)
    nb = n_out // batch
    return perm[:, :nb * batch].reshape(n_folds, nb, batch)


def loo_data(cfg, seed, device):
    """The collected set of ``objects`` x ``pokes_per_object`` rows: each
    object of one of ``num_classes`` materials (object i is class i mod
    C), a row the sum of its class's mean, its object's offset and noise.
    Returns (X (N, D), y (N,) int64, row offsets of the objects)."""
    g = generator(seed, device)
    n_obj, pokes, c, d = (cfg["objects"], cfg["pokes_per_object"],
                          cfg["num_classes"], cfg["features"])
    obj_class = torch.arange(n_obj, device=device) % c
    means = torch.randn(c, d, generator=g, device=device)
    offsets = torch.randn(n_obj, d, generator=g, device=device)
    x = torch.randn(n_obj, pokes, d, generator=g, device=device)
    x.mul_(0.8).add_((0.5 * means[obj_class] + 0.4 * offsets)[:, None])
    y = obj_class.repeat_interleave(pokes)
    return x.reshape(n_obj * pokes, d), y, np.arange(n_obj + 1) * pokes


# --------------------------------------------------------------------------
# Raw audio windows (aegan_m3's input, fmgan_m5.score7200's contact mic)
# --------------------------------------------------------------------------

def audio(g, labels, n_samples, sr, device):
    """Contact-mic-like windows: a decaying tone whose pitch depends on the
    material, a random amplitude, decay and phase, plus sensor noise."""
    n = len(labels)
    t = torch.arange(n_samples, device=device) / sr
    u = torch.rand(n, 4, generator=g, device=device)
    freq = 400.0 + 650.0 * labels.float() + 150.0 * u[:, 0]
    amp = 0.2 + 0.8 * u[:, 1]
    decay = 0.02 + 0.08 * u[:, 2]
    phase = 2 * math.pi * u[:, 3]
    x = torch.sin(2 * math.pi * freq[:, None] * t + phase[:, None])
    x.mul_(amp[:, None] * torch.exp(-t / decay[:, None]))
    return x.add_(0.02 * torch.randn(n, n_samples, generator=g,
                                     device=device))


def ae_data(cfg, seed, device):
    """(X (N, audio_len), y (N,) int64): ``rows_per_class`` raw windows of
    each material."""
    g = generator(seed, device)
    y = torch.arange(cfg["num_classes"], device=device).repeat_interleave(
        cfg["rows_per_class"])
    return audio(g, y, cfg["features"], cfg["sample_rate"], device), y


def ae_weights(cfg, n_folds, seed, device):
    """{"enc": [...], "dec": [...]} of {"w", "b"}: the program's layout."""
    from yardstick import ae_layers

    layers = ae_layers(cfg)
    leaves = _glorot_layers(seed, device, n_folds, layers)
    depth = len(cfg["encoder"])
    return {"enc": leaves[:depth], "dec": leaves[depth:]}


# --------------------------------------------------------------------------
# The scoring cell
# --------------------------------------------------------------------------

def poke_windows(cfg, n_pokes, seed, device):
    """One collected set: temperature and two fingertip forces of
    ``stream_len`` samples each (a step response with its own level,
    rise and noise) and the contact-mic window; labels are drawn too."""
    g = generator(seed, device)
    y = torch.randint(0, cfg["num_classes"], (n_pokes,), generator=g,
                      device=device)
    t = torch.linspace(0.0, 1.0, cfg["stream_len"], device=device)
    out = {}
    for name, level in (("temperature", 30.0), ("force0", 5.0),
                        ("force1", 5.0)):
        u = torch.rand(n_pokes, 2, generator=g, device=device)
        rise = 1.0 - torch.exp(-t / (0.05 + 0.3 * u[:, :1]))
        span = level * (0.2 + 0.2 * y[:, None].float() / cfg["num_classes"]
                        + 0.4 * u[:, 1:])
        out[name] = span * rise + 0.05 * level * torch.randn(
            n_pokes, cfg["stream_len"], generator=g, device=device)
    out["contact"] = audio(g, y, cfg["audio_len"], cfg["sample_rate"],
                           device)
    return out


def classifier_weights(cfg, seed, device):
    """One discriminator's {"d0".., "mid", "out"} of {"w": (in, out),
    "b": (out,)}."""
    from yardstick import disc_layers

    leaves = _glorot_layers(seed, device, 1, disc_layers(cfg))
    names = ["d%d" % i for i in range(len(cfg["disc_trunk"]))] + ["mid",
                                                                  "out"]
    return {n: {"w": p["w"][0], "b": p["b"][0]} for n, p in zip(names,
                                                               leaves)}
