"""The port's offline preprocessing (data/preprocess.py, cli/preprocess.py,
data/synthetic.py::generate_raw_file, data/py2pickle.py,
ops/resample.py::interp1d_batch) vs the JAX package's, on the CPU: the raw
files bit for bit, the py2 bytes, the processed pickles, and the dry-dock
cases of tests/test_py2_drydock.py on the port's loader and trainer."""

import os
import pickle
import pickletools

import numpy as np
import pytest
import torch

from mrgan_tpu.data import preprocess as jax_preprocess
from mrgan_tpu.data import py2pickle as jax_py2pickle
from mrgan_tpu.data import synthetic as jax_synthetic
from mrgan_tpu.ops import resample as jax_resample
from mrgan_tpu_torch import MATERIALS
from mrgan_tpu_torch.cli import preprocess as cli
from mrgan_tpu_torch.data import mreo, preprocess, py2pickle, synthetic
from mrgan_tpu_torch.ops import resample
from mrgan_tpu_torch.train import gan, protocol


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("kw", [
    dict(seed=0, material="plastic", pokes=2),
    dict(seed=5, material="metal", pokes=3, record_s=2.0, impact_s=0.5,
         dtype=np.float32),
    dict(seed=9, material="fabric", pokes=1, jitter=False)])
def test_generate_raw_file_is_the_jax_packages_bit_for_bit(kw):
    got = synthetic.generate_raw_file(**kw)
    want = jax_synthetic.generate_raw_file(**kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert len(got[k]) == len(want[k]) == kw["pokes"]
        for g, w in zip(got[k], want[k]):
            assert np.asarray(g).dtype == np.asarray(w).dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)
    assert synthetic.RAW_RATES == jax_synthetic.RAW_RATES


def _sample_processed_obj():
    rng = np.random.RandomState(0)
    return {
        "metal_bowl": {
            "temperature": [rng.randn(50).astype(np.float32) * 40
                            for _ in range(3)],
            "temperatureTime": [np.linspace(0, 0.5, 50)] * 3,
            "force0": [rng.randn(50).astype(np.float32) for _ in range(3)],
            "label": "métal",
            "bytes": b"\x00\xff" * 200,
        }
    }


def test_dumps_py2_gives_the_jax_packages_bytes(tmp_path):
    obj = _sample_processed_obj()
    assert py2pickle.dumps_py2(obj) == jax_py2pickle.dumps_py2(obj)
    raw = synthetic.generate_raw_file(seed=1, pokes=1, record_s=1.0,
                                      impact_s=0.3)
    assert py2pickle.dumps_py2(raw) == jax_py2pickle.dumps_py2(raw)
    py2pickle.dump_py2(obj, str(tmp_path / "a.pkl"))
    jax_py2pickle.dump_py2(obj, str(tmp_path / "b.pkl"))
    assert ((tmp_path / "a.pkl").read_bytes()
            == (tmp_path / "b.pkl").read_bytes())
    with pytest.raises(ValueError, match="latin1"):
        py2pickle.dumps_py2({"k": "中"})


def test_stream_is_py2_shaped():
    buf = py2pickle.dumps_py2(_sample_processed_obj())
    ops = [(op.name, arg) for op, arg, _ in pickletools.genops(buf)]
    names = {n for n, _ in ops}
    assert "SHORT_BINSTRING" in names or "BINSTRING" in names
    assert not any("BINUNICODE" in n for n in names)
    assert ("PROTO", 2) in ops
    globals_ = [arg for n, arg in ops if n == "GLOBAL"]
    assert any("numpy.core.multiarray" in g for g in globals_), globals_
    assert not any("numpy._core" in g for g in globals_), globals_


def test_ascii_load_fails_latin1_round_trips():
    obj = _sample_processed_obj()
    buf = py2pickle.dumps_py2(obj)
    with pytest.raises(UnicodeDecodeError):
        pickle.loads(buf)
    back = pickle.loads(buf, encoding="latin1")
    np.testing.assert_array_equal(
        np.asarray(back["metal_bowl"]["temperature"]),
        np.asarray(obj["metal_bowl"]["temperature"]))
    assert isinstance(next(iter(back)), str)


def _write_processed(path, writer, ft=0.5, c=0.05):
    path.mkdir(parents=True, exist_ok=True)
    data = synthetic.generate_processed(
        seed=0, forcetemp_time=ft, contactmic_time=c, pokes_per_object=3,
        objects_per_material=2)
    for material in MATERIALS:
        writer(data[material], mreo.processed_path(str(path), material, ft,
                                                   c))
    return str(path)


def test_port_loader_reads_py2_streams_identically(tmp_path):
    def py3_writer(obj, path):
        with open(path, "wb") as f:
            pickle.dump(obj, f, protocol=2)

    d2 = _write_processed(tmp_path / "py2", py2pickle.dump_py2)
    d3 = _write_processed(tmp_path / "py3", py3_writer)
    kw = dict(modalities=5, forcetemp_time=0.5, contactmic_time=0.05,
              device="cpu")
    x2, y2 = mreo.load_features(data_dir=d2, **kw)
    x3, y3 = mreo.load_features(data_dir=d3, **kw)
    assert torch.equal(x2, x3) and torch.equal(y2, y3)


def _raw_dir(path, pokes=4, objects=2, record_s=3.0):
    """generate_raw_file pickles, python-2 shaped, for every material."""
    path.mkdir(parents=True, exist_ok=True)
    for m, material in enumerate(MATERIALS):
        for o in range(objects):
            raw = synthetic.generate_raw_file(
                seed=10 * m + o, material=material, pokes=pokes,
                record_s=record_s, impact_s=0.8)
            py2pickle.dump_py2(raw, str(path / ("newdata_%s_obj%d_%dseqs.pkl"
                                                % (material, o, pokes))))
    return str(path)


def test_run_writes_the_jax_packages_processed_pickles(tmp_path):
    """Both packages on the CPU over the same raw directory: the same files
    and objects, every array within 1e-5 of its range (float32 rounding of
    the lerp, as tests/test_torch_resample.py holds it), stored float64."""
    raw = _raw_dir(tmp_path / "raw", pokes=2)
    configs = [preprocess.CONFIGS[4], preprocess.CONFIGS[12]]
    assert preprocess.CONFIGS == jax_preprocess.CONFIGS
    jax_preprocess.run(raw, str(tmp_path / "jax"), configs=configs,
                       verbose=False)
    cli.main(["--raw-dir", raw, "--out-dir", str(tmp_path / "port"),
              "--configs", "4", "12", "--device", "cpu"])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert len(names) == 12 and all(n.startswith("custom_") for n in names)
    for name in names:
        with open(tmp_path / "jax" / name, "rb") as f:
            want = pickle.load(f)
        with open(tmp_path / "port" / name, "rb") as f:
            got = pickle.load(f)
        assert sorted(got) == sorted(want)
        for obj in want:
            assert sorted(got[obj]) == sorted(want[obj])
            for k in want[obj]:
                g, w = np.asarray(got[obj][k]), np.asarray(want[obj][k])
                assert g.dtype == w.dtype == np.float64 and g.shape == w.shape
                np.testing.assert_allclose(
                    g, w, rtol=0, atol=1e-5 * max(np.ptp(w), 1.0),
                    err_msg="%s %s %s" % (name, obj, k))
    assert preprocess._object_name("x/newdata_glass_obj3_4seqs.pkl") == \
        "glass_obj3"


def test_py2_raw_pickles_through_preprocess_to_a_gan_cell(tmp_path):
    """tests/test_py2_drydock.py's full slice on the port: py2 raw pickles
    -> run (loader-visible names) -> load_features -> a tiny GAN cell."""
    raw = _raw_dir(tmp_path / "data_raw", pokes=4, objects=1)
    out = str(tmp_path / "data_processed")
    preprocess.run(raw, out, configs=[(0.5, 0.1)], prefix="", verbose=False,
                   device="cpu")
    assert mreo.have_processed(out, 0.5, 0.1)
    x, y = mreo.load_features(modalities=2, forcetemp_time=0.5,
                              contactmic_time=0.1, data_dir=out,
                              device="cpu")
    assert x.shape == (24, 150) and torch.isfinite(x).all()
    assert sorted(set(y.tolist())) == list(range(6))
    cfg = gan.GanConfig(noise_size=8, batch_size=6, epochs=2)
    errs = protocol.run_gan_cell(x, y, percentlabeled=100, cfg=cfg, seed=0,
                                 n_splits=2, device="cpu")
    assert errs.shape == (2,) and np.all((errs >= 0) & (errs <= 1))


def test_interp1d_batch_matches_the_jax_packages():
    rng = np.random.RandomState(3)
    x = np.sort(rng.rand(4, 60), axis=1).astype(np.float32)
    y = rng.randn(4, 60).astype(np.float32)
    x_new = (x[:, :1] + (x[:, -1:] - x[:, :1]) * rng.rand(4, 90)).astype(
        np.float32)
    want = np.asarray(jax_resample.interp1d_batch(x, y, x_new))
    got = resample.interp1d_batch(torch.tensor(x), torch.tensor(y),
                                  torch.tensor(x_new))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.ptp(want))


def test_cli_needs_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--raw-dir", str(tmp_path), "--out-dir", str(tmp_path)])
