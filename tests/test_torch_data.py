"""The PyTorch port's synthetic generator and loader vs mrgan_tpu's, on the
CPU: the generator bit for bit, load_features at modalities 2 and 5 from
the synthetic set and from processed pickles."""

import pickle

import numpy as np
import pytest
import torch

from mrgan_tpu.data import mreo as jax_mreo
from mrgan_tpu.data import synthetic as jax_synthetic
from mrgan_tpu_torch.data import mreo, synthetic
from mrgan_tpu_torch.ops import features, mel_cuda

FT_LEN = 400  # 4 s of force/temperature at 100 Hz


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("with_contact", [True, False])
def test_generate_processed_is_bitwise_the_jax_packages(with_contact):
    assert synthetic.GENERATOR_VERSION == jax_synthetic.GENERATOR_VERSION
    kw = dict(seed=3, pokes_per_object=2, objects_per_material=2,
              with_contact=with_contact)
    got = synthetic.generate_processed(**kw)
    want = jax_synthetic.generate_processed(**kw)
    assert list(got) == list(want)
    for material in want:
        assert list(got[material]) == list(want[material])
        for obj, arrays in want[material].items():
            assert set(got[material][obj]) == set(arrays)
            assert ("contact" in arrays) == with_contact
            for name, a in arrays.items():
                b = got[material][obj][name]
                assert b.dtype == a.dtype and b.shape == a.shape, name
                assert np.array_equal(b, a), (material, obj, name)


def _check_features(got, want, modality):
    x, y = got
    want_x, want_y = want
    assert x.device.type == "cpu" and x.dtype == torch.float32
    assert y.dtype == torch.int64
    np.testing.assert_array_equal(y.numpy(), want_y)
    assert x.shape == want_x.shape
    n_trace = 3 * FT_LEN
    np.testing.assert_array_equal(x[:, :n_trace].numpy(), want_x[:, :n_trace])
    if modality in features.NEEDS_AUDIO:
        assert x.shape[1] == n_trace + 128 * 19
        np.testing.assert_allclose(x[:, n_trace:].numpy(), want_x[:, n_trace:],
                                   atol=0.02)  # dB


@pytest.mark.parametrize("modality", [2, 5])
def test_load_features_matches_jax_on_the_synthetic_set(modality):
    kw = dict(modalities=modality, synthetic_seed=0,
              synthetic_kwargs={"pokes_per_object": 2})
    before = mel_cuda.launches
    got = mreo.load_features(device="cpu", **kw)
    assert mel_cuda.launches == before  # a CPU tensor never launches
    _check_features(got, jax_mreo.load_features(**kw), modality)
    assert len(got[1]) == 6 * 12 * 2


def test_load_features_reads_processed_pickles(tmp_path):
    synth = synthetic.generate_processed(seed=1, pokes_per_object=2,
                                         objects_per_material=3)
    for material, objects in synth.items():
        # python-2 pickles can surface keys as bytes
        blob = {name.encode("latin1"): {k.encode("latin1"): v
                                        for k, v in arrays.items()}
                for name, arrays in objects.items()}
        path = mreo.processed_path(str(tmp_path), material, 4, 0.2)
        with open(path, "wb") as f:
            pickle.dump(blob, f, protocol=2)
    assert mreo.have_processed(str(tmp_path))
    assert not mreo.uses_synthetic(str(tmp_path))
    got = mreo.load_features(5, data_dir=str(tmp_path), device="cpu")
    want = jax_mreo.load_features(5, data_dir=str(tmp_path))
    _check_features(got, want, 5)
    assert len(got[1]) == 6 * 3 * 2


def test_require_processed_forbids_the_synthetic_fallback(tmp_path,
                                                          monkeypatch):
    assert mreo.uses_synthetic(str(tmp_path))
    monkeypatch.setenv("MRGAN_REQUIRE_PROCESSED", "1")
    with pytest.raises(FileNotFoundError, match="MRGAN_REQUIRE_PROCESSED"):
        mreo.load_features(2, data_dir=str(tmp_path), device="cpu")
    # an explicit synthetic seed is allowed
    x, _ = mreo.load_features(2, data_dir=str(tmp_path), synthetic_seed=0,
                              synthetic_kwargs={"pokes_per_object": 1},
                              device="cpu")
    assert x.shape == (72, 3 * FT_LEN)


def test_synthetic_memo_serves_an_audio_free_request():
    kw = dict(synthetic_seed=5, synthetic_kwargs={"pokes_per_object": 1},
              device="cpu")
    x5, _ = mreo.load_features(5, **kw)
    value = mreo._MEMO["value"]
    x2, _ = mreo.load_features(2, **kw)
    assert mreo._MEMO["value"] is value  # no second synthesis
    np.testing.assert_array_equal(x2.numpy(), x5[:, :3 * FT_LEN].numpy())


@pytest.mark.parametrize("modality", [2, 5])
def test_load_features_deriv_matches_jax(modality):
    kw = dict(modalities=modality, synthetic_seed=0, deriv=True,
              synthetic_kwargs={"pokes_per_object": 2})
    x, y = mreo.load_features(device="cpu", **kw)
    want_x, want_y = jax_mreo.load_features(**kw)
    np.testing.assert_array_equal(y.numpy(), want_y)
    n_trace = 3 * FT_LEN
    np.testing.assert_allclose(x[:, :n_trace].numpy(), want_x[:, :n_trace],
                               rtol=1e-6)
    plain, _ = mreo.load_features(device="cpu", **{**kw, "deriv": False})
    assert not torch.equal(plain[:, :n_trace], x[:, :n_trace])
    if modality in features.NEEDS_AUDIO:  # the audio is not differentiated
        np.testing.assert_array_equal(x[:, n_trace:].numpy(),
                                      plain[:, n_trace:].numpy())
