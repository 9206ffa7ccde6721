"""A run with the timed path broken underneath comes out not correct, and so
does the control (the reference in the precision below the configuration's,
in the program's place); a sound run comes out correct. The harness runs on
the CPU at the tiny size, past its look for a chip."""

import pytest
import torch

import rtnr_tpu_torch.pipeline as pipeline
import rtnr_tpu_torch.train.trainer as tt
from rtnr_bench import calibrate, harness

WALK, STEPS = "building50m-int8-1080p.walk", "room5m-train-1080p.steps"


def run(root, cell, seed=7, seconds=0.4):
    return harness.execute(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds)],
                           root=root, device="cpu")


@pytest.mark.parametrize("cell", [WALK, STEPS])
def test_sound_runs_are_correct(tiny_root, one_thread, cell):
    out = run(tiny_root, cell)
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


def _wrap_compute_full(monkeypatch, alter):
    orig = pipeline.Renderer.compute_full
    state = {}

    def compute_full(self, camera, extrinsics, timings=False):
        out = orig(self, camera, extrinsics)
        return alter(out, state)

    monkeypatch.setattr(pipeline.Renderer, "compute_full", compute_full)


def _stale(out, state):
    prev = state.get("prev")
    state["prev"] = out
    return prev if prev is not None else out


def _pixel(out, state):
    out["raw_rgb"] = out["raw_rgb"].copy()
    out["raw_rgb"][5, 7, 0] ^= 1
    return out


def _unet_value(out, state):
    out["rgb_f"] = out["rgb_f"].copy()
    out["rgb_f"][3, 4, 1] += 0.5
    return out


@pytest.mark.parametrize("alter", [_stale, _pixel, _unet_value],
                         ids=["frame_unchanged", "raw_pixel_altered", "unet_value_altered"])
def test_walk_faults_are_caught(tiny_root, one_thread, monkeypatch, alter):
    _wrap_compute_full(monkeypatch, alter)
    out = run(tiny_root, WALK)
    assert out["correct"] is False


def test_walk_culling_that_drops_points_is_caught(tiny_root, one_thread, monkeypatch):
    orig = pipeline.compact_points

    def compact(points, colors, keep, budget):
        keep = keep.clone()
        kept = torch.nonzero(keep).squeeze(1)
        keep[kept[::2]] = False
        return orig(points, colors, keep, budget)

    monkeypatch.setattr(pipeline, "compact_points", compact)
    out = run(tiny_root, WALK)
    assert out["correct"] is False and out["checks"]["raw_px_diff"]["value"] > 0


def test_walk_wrong_scales_are_caught(tiny_root, one_thread, monkeypatch):
    orig = pipeline.calibrate_act_scales
    monkeypatch.setattr(pipeline, "calibrate_act_scales",
                        lambda unet, x: {k: v * 2.0 for k, v in orig(unet, x).items()})
    out = run(tiny_root, WALK)
    assert out["correct"] is False


def _wrap_step(monkeypatch, make):
    orig = tt.make_train_step
    monkeypatch.setattr(tt, "make_train_step", lambda **kw: make(orig, **kw))


def _frozen(which):
    """A step that leaves the parameters ``which`` names as they were."""
    def make(orig, **kw):
        step = orig(**kw)

        def frozen(state, *a):
            saved = [(p, p.detach().clone()) for k, p in state.model.named_parameters()
                     if which(k)]
            state, met = step(state, *a)
            with torch.no_grad():
                for p, s in saved:
                    p.copy_(s)
            return state, met
        return frozen
    return make


def _output_altered(orig, **kw):
    step = orig(**kw)

    def altered(state, *a):
        if not getattr(state.model, "_altered", False):
            fwd = state.model.forward

            def forward(x):
                y = fwd(x).clone()
                y[:, 0] += 1.0  # the net's first row of answers, where it is produced
                return y
            state.model.forward = forward
            state.model._altered = True
        return step(state, *a)
    return altered


def _half_rows(orig, **kw):
    return orig(loss_fn=lambda pred, target: tt.l1_loss(pred[:, ::2], target[:, ::2]), **kw)


@pytest.mark.parametrize("make", [_frozen(lambda k: True), _frozen(lambda k: "__bn" in k),
                                  _frozen(lambda k: k == "final_conv__bias"), _output_altered,
                                  _half_rows],
                         ids=["state_unchanged", "batchnorm_affine_frozen",
                              "one_small_leaf_frozen", "output_altered", "half_the_rows"])
def test_training_faults_are_caught(tiny_root, one_thread, monkeypatch, make):
    _wrap_step(monkeypatch, make)
    out = run(tiny_root, STEPS)
    assert out["correct"] is False


@pytest.mark.parametrize("cell", [WALK, STEPS])
def test_the_control_is_not_correct(tiny_root, one_thread, cell):
    limits = harness.load_json(harness.find(tiny_root, "configs", cell.split(".")[0],
                                            ".json"))["limits"]
    (r,) = calibrate.readings(cell, [9], {"control": [9]}, 0.3, device="cpu", root=tiny_root)
    assert all(v <= limits[k] for k, v in r["program"].items()), r
    assert any(v > limits[k] for k, v in r["control"].items()), r
