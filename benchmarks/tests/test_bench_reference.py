"""The plain reference against the program at tiny sizes on the CPU: a GAN
step with Adam, an autoencoder step, and a scored request."""

import pytest
import torch

import inputs
from reference import mel as ref_mel
from reference import nets as ref

CFG = {"features": 40, "disc_trunk": [1000, 500, 250, 250], "disc_mid": 250,
       "num_classes": 6, "gen_hidden": 500, "noise_size": 100,
       "batch_size": 8}


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_gan_step_with_adam(moments):
    from mrgan_tpu_torch.train import gan

    torch.set_num_threads(2)
    f, b, d = 2, CFG["batch_size"], CFG["features"]
    g = torch.Generator().manual_seed(0)
    params = inputs.gan_weights(CFG, f, 1, "cpu")
    draws = inputs.gan_draws(CFG, f, 2, "cpu")
    xl, xu, xu2 = (torch.randn(f, b, d, generator=g) for _ in range(3))
    yl = torch.randint(0, 6, (f, b), generator=g)
    gcfg = gan.GanConfig(batch_size=b, opt_state_dtype=moments)
    state = gan.init_state(params, gcfg)
    rstate = ref.init_state(inputs.flat(params), getattr(torch, moments))
    for _ in range(2):
        state, out = gan.batch_step(state, xl, yl, xu, xu2, draws, cfg=gcfg)
        rstate, rout = ref.gan_step(rstate, xl, yl, xu, xu2, draws, 4)
        torch.testing.assert_close(torch.stack(out[:2]), torch.stack(rout),
                                   rtol=1e-5, atol=1e-6)
    prog = inputs.flat({"disc": state["disc"], "gen": state["gen"]})
    for name, p in prog.items():
        change = rstate["p"][name] - inputs.flat(params)[name]
        gap = (p - rstate["p"][name]).norm() / change.norm()
        assert gap < (1e-4 if moments == "float32" else 1e-2), name


def test_autoencoder_step():
    from mrgan_tpu_torch.train import optim
    from mrgan_tpu_torch.variants import autoencoder

    torch.set_num_threads(2)
    cfg = {"features": 48, "encoder": [16, 8, 4]}
    params = inputs.ae_weights(cfg, 3, 5, "cpu")
    x = torch.randn(3, 8, 48, generator=torch.Generator().manual_seed(1))
    acfg = autoencoder.AeConfig(nodes=(16, 8, 4), batch_size=8)
    state = {"params": params, "opt": optim.init(params)}
    rstate = ref.init_state(inputs.flat(params), torch.float32)
    for _ in range(3):
        state, loss = autoencoder.ae_train_step(state, x, acfg)
        rstate, rloss = ref.ae_step(rstate, x, 3)
        torch.testing.assert_close(loss, rloss, rtol=1e-6, atol=1e-7)
    for name, p in inputs.flat(state["params"]).items():
        torch.testing.assert_close(p, rstate["p"][name], rtol=1e-5,
                                   atol=1e-6)


def test_log_mel_matches_the_program_plain_path():
    from mrgan_tpu_torch.ops import mel

    torch.set_num_threads(2)
    y = torch.arange(6).repeat(2)
    audio = inputs.audio(torch.Generator().manual_seed(3), y, 4800, 48000,
                         "cpu")
    ours = ref_mel.LogMel("cpu")(audio)
    theirs = mel.frontend_logmel(audio)
    assert ours.shape == theirs.shape == (12, 128 * 10)
    assert float((ours - theirs).abs().max()) < 1e-3


def test_scored_request():
    from mrgan_tpu_torch import serve
    from mrgan_tpu_torch.models import nets

    torch.set_num_threads(2)
    cfg = dict(CFG, features=3 * 8 + 128 * 4, stream_len=8, audio_len=1536,
               sample_rate=48000)
    weights = inputs.classifier_weights(cfg, 7, "cpu")
    disc = nets.Discriminator(cfg["features"], 6, generator=torch.Generator())
    with torch.no_grad():
        for name, p in weights.items():
            getattr(disc, name).weight.copy_(p["w"].T)
            getattr(disc, name).bias.copy_(p["b"])
    s = inputs.poke_windows(cfg, 20, 8, "cpu")
    feats = torch.cat([s["temperature"], s["force0"], s["force1"],
                       ref_mel.LogMel("cpu")(s["contact"])], dim=-1)
    mean, std = ref.scaler_fit(feats)
    clf = serve.MaterialClassifier(disc, mean, 1.0 / std, modality=5,
                                   device="cpu")
    p = {"disc.%s.%s" % (n, k): t[None] for n, d in weights.items()
         for k, t in d.items()}
    logits, _ = ref.discriminator(p, ((feats - mean) / std)[None], 4)
    torch.testing.assert_close(clf.predict_logits(feats), logits[0],
                               rtol=1e-5, atol=1e-5)
    names = clf.classify_pokes(**s)
    assert names == [clf.materials[i] for i in logits[0].argmax(-1).tolist()]
