"""The benchmark's arithmetic: ops and bytes against hand counts at the
1088x1920 frame, the shares the readers derive, and idle share from a
synthetic trace."""

from types import SimpleNamespace

import pytest

from rtnr_bench import flops, record, tracing
from rtnr_bench.harness import load_module
from rtnr_bench.tests.conftest import ROOT

H, W = 1088, 1920
M = H * W
FEATURES = (64, 128, 256, 512)


def by_name(mode):
    return {c["name"]: c for c in flops.unet_calls(FEATURES, H, W, mode)}


def test_static_counts_by_hand():
    c = by_name("static")
    assert len(c) == 22  # 18 3x3 convs and 4 ConvTransposes
    # the input conv: bf16 operands, int8 codes out
    assert c["down0/conv0"]["ops"] == {"bf16": 2.0 * M * 64 * 9 * 5}
    assert c["down0/conv0"]["bytes"] == 2 * M * 5 + 2 * 9 * 5 * 64 + 8 * 64 + M * 64
    # an encoder conv1 with its pool: int8 in and out
    assert c["down0/conv1"]["ops"] == {"int8": 2.0 * M * 64 * 9 * 64}
    assert c["down0/conv1"]["bytes"] == M * 64 + 9 * 64 * 64 + 8 * 64 + M * 64 + M * 64 / 4
    # a decoder conv0 over [skip, up]
    m3 = (H // 8) * (W // 8)
    assert c["updc0/conv0"]["ops"] == {"int8": 2.0 * m3 * 512 * 9 * 1024}
    # the ConvTranspose from the bottleneck
    m4 = (H // 16) * (W // 16)
    assert c["up0"]["ops"] == {"int8": 2.0 * m4 * 4 * 512 * 1024}
    assert c["up0"]["bytes"] == m4 * 1024 + 4 * 1024 * 512 + 8 * 512 + 4 * m4 * 512
    # the last conv writes bf16 for the 1x1 head
    assert c["updc3/conv1"]["ops"] == {"int8": 2.0 * M * 64 * 9 * 64, "bf16": 2.0 * M * 64 * 3}
    assert c["updc3/conv1"]["bytes"] == M * 64 + 9 * 64 * 64 + 8 * 64 + 2 * M * 3


def test_least_times_and_totals():
    c = by_name("static")
    k = c["down0/conv1"]
    assert flops.least_s(k) == max(k["ops"]["int8"] / 1979e12, k["bytes"] / 3.35e12)
    total = flops.total_ops(list(c.values()))
    assert total == flops.total_ops(list(by_name("bf16").values()))
    assert total == pytest.approx(3.076e12, rel=1e-3)  # the forward's 3.08 T ops
    # the 17 static 3x3 convs: the chip check's bound of 1.4911 ms (PERF.md)
    k3 = [v for n, v in c.items() if not n.startswith(("up0", "up1", "up2", "up3"))
          and n != "down0/conv0"]
    assert len(k3) == 17
    assert sum(flops.least_s(v) for v in k3) * 1e3 == pytest.approx(1.4911, rel=0.02)


def fake_run(**kw):
    base = dict(device="cuda", frames=[], steps=0, window_s=None, traced=None,
                config={"camera": {"width": W, "height": 1080},
                        "render": {"pyramid_levels": 4, "unet_int8": "static",
                                   "unet_features": list(FEATURES)},
                        "train": {"pyramid_levels": 4, "unet_features": list(FEATURES),
                                  "batch": 1}})
    base.update(kw)
    return SimpleNamespace(**base)


def reader(name):
    return load_module(ROOT / "rtnr_bench" / "metrics" / f"{name}.py").read


def test_mfu_and_roofline_readers():
    frames = [dict(latency_ms=25.0, projection_ms=3.0, filter_ms=5.0, unet_ms=4.0,
                   kept_share=0.1, recomputed=False)] * 4
    run = fake_run(frames=frames)
    calls = record.serve_calls(run)
    assert reader("mfu.serve")(run) == pytest.approx(100 * flops.math_s(calls) / 0.025)
    assert reader("unet_roofline")(run) == pytest.approx(
        100 * sum(flops.least_s(c) for c in calls) / 0.004)
    assert reader("entry.outside_stages_ms")(run) == pytest.approx(13.0)
    assert reader("cull.kept_share")(run) == pytest.approx(10.0)
    train = fake_run(steps=100, window_s=17.6)
    assert reader("mfu.train")(train) == pytest.approx(
        100 * 3 * 3.076e12 / 989e12 / 0.176, rel=1e-3)
    assert reader("step_ms")(train) == pytest.approx(176.0)
    # no device: no device metric
    assert reader("mfu.serve")(fake_run(frames=frames, device="cpu")) is None


def ev(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur}


def test_idle_share_from_a_synthetic_trace():
    events = [
        ev(tracing.WINDOW_SPAN, "user_annotation", 0, 1000),
        ev("kernel_a", "kernel", 100, 200),  # 100-300
        ev("kernel_b", "kernel", 250, 100),  # 250-350 overlaps a
        ev("Memcpy DtoH", "gpu_memcpy", 600, 100),  # 600-700
        ev("kernel_a", "kernel", 950, 100),  # 950-1050, cut at the window's end
        ev("aten::sort", "cpu_op", 340, 300),  # holds the gap 350-600
        ev("compute_full", "cpu_op", 0, 1000),  # holds everything
        ev("outside", "kernel", 2000, 10),
    ]
    s = tracing.summarize(events)
    assert s["window_s"] == pytest.approx(1000e-6)
    assert s["busy_s"] == pytest.approx((250 + 100 + 50) * 1e-6)
    gaps = dict(s["idle_gaps"])
    assert gaps["aten::sort"] == pytest.approx(250e-6)
    assert gaps["compute_full"] == pytest.approx((100 + 250) * 1e-6)
    ops = dict(s["device_ops"])
    assert ops["kernel_a"] == pytest.approx(250e-6) and "outside" not in ops
    run = fake_run(traced=s)
    assert record.idle_share(run) == pytest.approx(60.0)
    assert reader("idle_share.serve")(run) == pytest.approx(60.0)


def test_a_trace_without_device_work_reads_nothing():
    s = tracing.summarize([ev(tracing.WINDOW_SPAN, "user_annotation", 0, 1000)])
    assert s["busy_s"] == 0.0
    assert record.idle_share(fake_run(traced=s)) is None
    assert tracing.summarize([])["busy_s"] is None
