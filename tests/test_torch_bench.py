"""The port's benchmark line (``rtnr_tpu_torch.bench``) on the CPU at a tiny
size: ``bench.py``'s JSON fields, the trajectory it renders, and the int8
fallback decision at the reference's export shapes against the JAX
package's (``phase_input_ok``, its TPU-only term forced)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtnr_tpu.models.unet import UNet as JUNet
from rtnr_tpu.models.unet import phase_input_ok
from rtnr_tpu.pipeline import pyramid_pad_shape as j_pad_shape
from rtnr_tpu_torch import bench

@pytest.fixture(autouse=True)
def one_thread():
    """A tiny frame is hundreds of small ops; with the suite's other workers
    on the same cores, torch's intra-op threads spin against them (6 copies
    of this file in parallel took 206 s each against 6 s alone), so these
    tests run torch on one thread and restore the count after. The CLI,
    checkpoint, U-Net and pipeline test files import this fixture too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIELDS = {"metric", "value", "unit", "vs_baseline", "trials", "unet_int8", "batch",
          "points_per_s", "pixels_per_s", "ms_per_frame", "device"}
TINY = dict(n_points=20_000, width=64, height=64, frames=2, trials=2,
            features=(8, 16, 32, 64), device="cpu")


@pytest.mark.parametrize("mode, both", [("static", True), ("dyn", True), ("off", True),
                                        ("static", False)])
def test_run_prints_bench_fields(mode, both):
    rec = bench.run(**TINY, int8_mode=mode, both=both)
    extra = {"fps_bf16_exact", "ms_per_frame_bf16"} if mode == "static" and both else set()
    assert set(rec) == FIELDS | extra
    assert rec["metric"] == "fps_64x64_full_pipeline_0Mpts" and rec["unit"] == "frames/s"
    assert rec["unet_int8"] == mode and rec["batch"] == 1 and rec["device"] == "cpu"
    assert len(rec["trials"]) == 2 and rec["value"] in rec["trials"]
    assert rec["value"] == sorted(rec["trials"])[1] > 0
    assert rec["vs_baseline"] == round(rec["value"] / 30.0, 3)
    assert rec["points_per_s"] == round(rec["value"] * 20_000, 0)
    assert rec["pixels_per_s"] == round(rec["value"] * 64 * 64, 0)
    assert rec["ms_per_frame"] == round(1e3 / rec["value"], 2)
    json.dumps(rec)


@pytest.mark.parametrize("width, height", [(1920, 1080), (960, 720), (1440, 1440),
                                           (1024, 768), (2048, 1088)])
def test_fallback_decision_is_jax_bench(width, height, capsys):
    """bench.py falls back where ``phase_input_ok`` fails at the padded
    frame; at 1920x1080 the port keeps static int8."""
    jnet = JUNet(features=bench.FEATURES, dtype=jnp.bfloat16, fold_bn=True, quant_int8=True)
    quantises = phase_input_ok(jnet, *j_pad_shape(height, width, 4), force=True)
    mode = bench.headline_mode("static", width, height)
    assert mode == ("static" if quantises else "off")
    note = "falling back to bf16" in capsys.readouterr().err
    assert note == (not quantises)
    assert bench.headline_mode("off", width, height) == "off"
    if (width, height) in ((960, 720), (1440, 1440)):
        assert mode == "off"
    if (width, height) == (1920, 1080):
        assert mode == "static"


def test_run_falls_back_where_int8_does_not_apply(capsys):
    rec = bench.run(**{**TINY, "height": 48, "trials": 1})
    assert rec["unet_int8"] == "off" and "fps_bf16_exact" not in rec
    assert "falling back to bf16" in capsys.readouterr().err
    with pytest.raises(ValueError, match="BENCH_UNET_INT8"):
        bench.headline_mode("fp8", 64, 64)


def test_batch_keeps_whole_steps():
    """BENCH_BATCH is reported as read; the trajectory keeps bench.py's
    ceil(frames / batch) * batch frames."""
    rec = bench.run(**{**TINY, "frames": 3, "trials": 1}, batch=2, int8_mode="off")
    assert rec["batch"] == 2 and rec["unet_int8"] == "off"


def test_main_needs_the_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for k, v in dict(BENCH_POINTS="1000", BENCH_WIDTH="64", BENCH_HEIGHT="64",
                     BENCH_FRAMES="1", BENCH_TRIALS="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main()
