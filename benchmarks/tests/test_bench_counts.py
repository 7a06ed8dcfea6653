"""The yardstick's counts against hand counts, and the trace reduction on a
made-up trace."""

import json

import pytest

import harness
import yardstick
from conftest import BENCH_DIR


def config(name):
    return json.loads((BENCH_DIR / "configs" / (name + ".json")).read_text())


def test_gan_fold_step_by_hand():
    # D 3632-1000-500-250-250-250-6 (4,383,500 MACs a row), G 100-500-500-
    # 3632 (2,116,000): G fwd 50 rows twice, D fwd 150 + dW 150 + dX 150
    # without the first layer's 3,632,000, D fwd 100 + dX 100 without the
    # out layer's 1,500, G dW 50 + dX 50 without the first layer's 50,000.
    md, mg = 4_383_500, 2_116_000
    per_row = (2 * mg + 3 * md + 3 * md + 3 * (md - 3_632_000) + 2 * md
               + 2 * (md - 1_500) + mg + (mg - 50_000))
    assert per_row == 54_500_500
    assert yardstick.gan_fold_step_flops(config("fmgan_m5")) \
        == 2 * 50 * per_row == 5_450_050_000


def test_ae_fold_step_by_hand():
    # 9600-1024-512-256-512-1024-9600: 20,971,520 MACs a row (21.0 M
    # weights); forward, dW, dX without the first layer's 9,830,400.
    macs = 2 * (9600 * 1024 + 1024 * 512 + 512 * 256)
    assert macs == 20_971_520
    assert yardstick.ae_fold_step_flops(config("aegan_m3")) \
        == 2 * 32 * (3 * macs - 9_830_400) == 3_397_386_240


def test_score_poke_by_hand():
    frame = yardstick.mel_frame_flops()
    nonzero = (frame - 2048 - 2.5 * 2048 * 11 - 3 * 1025) / 2
    assert nonzero == int(nonzero) and 1025 < nonzero < 2 * 1025
    assert yardstick.score_poke_flops(config("fmgan_m5")) \
        == 19 * frame + 2 * 4_383_500


@pytest.mark.parametrize("rows,row_len,frames,ms", [
    (72, 9600 + 2048, 1368, 0.00134),      # PR 4's F = 1,368 bound
    (512, 48000 + 2048, 48128, 0.0470),    # PR 4's F = 48,128 bound
])
def test_mel_bound_matches_the_recorded_bounds(rows, row_len, frames, ms):
    seconds, which = yardstick.mel_bound(rows, row_len, frames)
    assert which == "operations"
    assert round(seconds * 1e3, 5 if ms < 0.01 else 4) == ms


def test_trace_reduction():
    ev = [(0, 100, "aten::add", False), (10, 40, "k1", True),
          (30, 60, "k2", True), (80, 90, "Memcpy HtoD", True),
          (60, 75, "cudaLaunchKernel", False)]
    out = harness.reduce_trace(ev, 1e-7)
    assert out["busy_s"] == pytest.approx(60e-9)
    assert out["launches"] == 2
    assert dict(out["device_ops"])["k1"] == pytest.approx(30e-9)
    gaps = dict(out["idle_gaps"])
    # 0-10 under aten::add, 60-80 from the launch at 60-75, 90-100 none
    assert gaps["aten::add"] == pytest.approx(10e-9)
    assert gaps["cudaLaunchKernel"] == pytest.approx(20e-9)
