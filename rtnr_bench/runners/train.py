"""Back-to-back U-Net training steps, as the training CLI takes them.

Set-up makes the room and the U-Net weights from the seed on the device,
uploads the scene as the training CLI does (``sorted_by_block()
.device_arrays(8)``), builds ``create_train_state`` (UNetTrain in
``dtype`` with f32 BatchNorm, Adam at ``learning_rate``) and
``make_train_step``, and makes a pool of camera matrices (the traffic's
generator) and targets (uniform in [0, 1], made on the device). The first
three steps run in set-up through the same call and feed as the window's
steps, on the pool's first three views; they are the ones the reference
follows. The window then steps on through the pool, one frame a step,
every step ending in a read of its loss.

After the window (and the traced steps, with ``--trace 1``) the state is
freed and the f32 reference (``reference/train.py``) repeats the first
three steps from the same weights, views and targets. Compared:

- ``input_diff``: elements of the first step's U-Net input (the rendered,
  prefiltered frame the model received) that differ from the reference's;
- ``out_gap``: the first step's U-Net output against the reference's, the
  norm of the difference over the reference's norm;
- ``grad_gap``: the first gradient as Adam got it (its first moment after
  one step over 1 - b1), the worst leaf's gap of norms over that leaf's
  reference norm;
- ``update_gap``: the same for the parameters' change over the three
  steps;
- ``stats_gap``: the same for the change of the BatchNorm running
  statistics;
- ``loss_gap``: the largest relative gap of the three steps' losses.

``grad_gap`` and ``update_gap`` take the leaves whose reference gradient
is not nought to rounding (``moving_leaves``); a leaf left unmoved, or
moved double, reads 1.

What can stand in the program's place (``STAND_INS``, for
``calibrate.py``): ``control``, the reference with float8 e4m3 convs;
``frozen``, the reference with a learning rate of 0, a state left
unchanged.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from rtnr_bench import scenes, tracing, weights
from rtnr_bench.harness import Run, find, load_module
from rtnr_bench.reference import render as ref_render
from rtnr_bench.reference.train import B1, RefTrainer, moving_leaves, norm_gaps, rel_gap

FOLLOWED = 3  # steps the reference follows
STAND_INS = ("control", "frozen")


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def _name(key: str) -> str:
    return key.replace("__", "/")


def build(rec: Run):
    import rtnr_tpu_torch.train.trainer as tt
    from rtnr_tpu_torch.camera import Camera
    from rtnr_tpu_torch.scene import Scene

    cfg, dev = rec.config, rec.device
    t0 = time.time()
    pts, cols = scenes.make_scene(cfg["scene"], rec.seed, dev)
    arrays = (pts.cpu().numpy(), cols.cpu().numpy())
    del pts, cols
    p, c, v = Scene.from_arrays(*arrays).sorted_by_block().device_arrays(8)
    feed = tuple(torch.from_numpy(a).to(dev) for a in (p, c, v))
    tc = cfg["train"]
    features = tuple(tc["unet_features"])
    variables = weights.unet_variables(rec.seed, features, dev)
    state = tt.create_train_state(variables, features=features, dtype=getattr(torch, tc["dtype"]),
                                  learning_rate=tc["learning_rate"], device=dev)
    cam = Camera.from_params(**cfg["camera"])
    step = tt.make_train_step(width=cam.width, height=cam.height, depth_band=tc["depth_band"],
                              levels=tc["pyramid_levels"], filter_strength=tc["filter_strength"],
                              gradient_filter=tc["gradient_filter"])
    gen = load_module(find(rec.root, "traffic", rec.traffic["generator"], ".py"))
    poses = gen.poses(cfg, rec.traffic, rec.seed)
    projs = torch.from_numpy(np.stack([cam.cam_proj(E).astype(np.float32) for E in poses])).to(dev)
    g = scenes.generator(rec.seed ^ 0x7A26_E75, dev)
    targets = torch.rand((len(poses), cam.height, cam.width, 3), generator=g, device=dev)
    _sync(dev)
    rec.scene_s = time.time() - t0
    return state, step, feed, projs, targets, poses, cam, arrays, variables


def _clone(named) -> Dict[str, torch.Tensor]:
    return {_name(k): t.detach().clone() for k, t in named}


def measure(rec: Run) -> Dict:
    """Set-up, the three followed steps, the window and the traced steps;
    the program freed, what the reference needs."""
    state, step, feed, projs, targets, poses, cam, arrays, variables = build(rec)
    n = len(poses)
    sel = lambda i: (projs[i % n:i % n + 1], targets[i % n:i % n + 1])
    model, opt = state.model, state.optimizer
    params0, stats0 = _clone(model.named_parameters()), _clone(model.named_buffers())
    seen = {}
    def keep_input(module, args):  # a hook returns None: it changes nothing
        seen.setdefault("x", args[0].detach().clone())

    def keep_output(module, args, out):
        seen.setdefault("y", out.detach().clone())

    hooks = [model.register_forward_pre_hook(keep_input), model.register_forward_hook(keep_output)]
    losses = []
    for i in range(FOLLOWED):
        state, met = step(state, *feed, *sel(i))
        losses.append(float(met["loss"]))
        if i == 0:
            for h in hooks:
                h.remove()
            g1 = {_name(k): opt.state[p]["exp_avg"].detach().clone() / (1.0 - B1)
                  for k, p in model.named_parameters()}
    params3, stats3 = _clone(model.named_parameters()), _clone(model.named_buffers())
    i = FOLLOWED
    t_w0 = time.time()
    rec.setup_s = t_w0 - rec.t_start
    t = t_w0
    while t - t_w0 < rec.seconds:
        state, met = step(state, *feed, *sel(i))
        float(met["loss"])
        i += 1
        t = time.time()
    rec.window_s = t - t_w0
    rec.steps = i - FOLLOWED
    rec.extra["attempted"] = rec.steps
    if rec.device == "cuda":
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated()
    if rec.trace:
        def steps():
            nonlocal state
            for k in range(rec.traffic["trace_steps"]):
                state, met = step(state, *feed, *sel(i + k))
                float(met["loss"])
        rec.traced = tracing.traced(steps, rec.device)
    x_prog, y_prog = seen["x"], seen["y"]
    del state, model, opt, step, feed, met
    gc.collect()
    if rec.device == "cuda":
        torch.cuda.empty_cache()
    prog = {"x": x_prog, "y": y_prog, "losses": losses, "g1": g1,
            "d_params": {k: params3[k] - params0[k] for k in params0},
            "d_stats": {k: stats3[k] - stats0[k] for k in stats0}}
    return {"cam": cam, "arrays": arrays, "variables": variables, "poses": poses,
            "targets": targets, "prog": prog}


def follow(rec: Run, cam, arrays, variables, poses, targets, lowp: bool = False,
           lr: Optional[float] = None) -> Dict:
    """The reference's first three steps: inputs, losses, first gradient,
    the change of parameters and statistics (``lr``: in place of the
    configuration's learning rate)."""
    cfg, dev = rec.config, rec.device
    tc = cfg["train"]
    points = torch.from_numpy(arrays[0]).to(dev)
    colors = torch.from_numpy(arrays[1]).to(dev)
    ref = RefTrainer(variables, tc["unet_features"], dev,
                     tc["learning_rate"] if lr is None else lr, lowp=lowp)
    p0 = {k: v.detach().clone() for k, v in ref.params.items()}
    s0 = {k: v.clone() for k, v in ref.stats.items()}
    out = {"losses": []}
    for i in range(FOLLOWED):
        x = ref_render.render_input(points, colors, ref_render.cam_proj(cam.K, poses[i]),
                                    cam.width, cam.height, tc)["unet_input"][None]
        loss, g, y = ref.step(x, targets[i:i + 1])
        out["losses"].append(loss)
        if i == 0:
            out["x"], out["g1"], out["y"] = x, g, y
    out["d_params"] = {k: ref.params[k].detach() - p0[k] for k in p0}
    out["d_stats"] = {k: ref.stats[k] - s0[k] for k in s0}
    return out


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The compared numbers; the worst leaves go to standard error."""
    if prog["x"].shape != ref["x"].shape:
        return {"input_diff": float("inf")}
    moving = moving_leaves(ref["g1"])
    gaps = {"grad_gap": norm_gaps(prog["g1"], ref["g1"], moving),
            "update_gap": norm_gaps(prog["d_params"], ref["d_params"], moving),
            "stats_gap": norm_gaps(prog["d_stats"], ref["d_stats"], list(ref["d_stats"]))}
    for k, v in gaps.items():
        print(f"{k} worst leaves (gap, leaf, program norm, reference norm): {v[:3]}",
              file=sys.stderr)
    print(f"losses {prog['losses']} reference {ref['losses']}", file=sys.stderr)
    return {"input_diff": float((prog["x"] != ref["x"]).sum()),
            "out_gap": rel_gap(prog["y"], ref["y"]),
            **{k: v[0][0] for k, v in gaps.items()},
            "loss_gap": max(abs(a / b - 1.0) for a, b in zip(prog["losses"], ref["losses"]))}


def checks(rec: Run, ctx: Dict, stand_in: Optional[str] = None) -> Dict[str, float]:
    """The numbers read against the reference: of the program, or of what
    ``stand_in`` names in its place."""
    args = (rec, ctx["cam"], ctx["arrays"], ctx["variables"], ctx["poses"], ctx["targets"])
    prog = {None: lambda: ctx["prog"], "control": lambda: follow(*args, lowp=True),
            "frozen": lambda: follow(*args, lr=0.0)}[stand_in]()
    out = compare(prog, follow(*args))
    lim = rec.config["limits"]
    rec.extra["failed"] = int(any(not v <= lim[k] for k, v in out.items()))
    return out


def run(rec: Run) -> None:
    ctx = measure(rec)
    t0 = time.time()
    for k, v in checks(rec, ctx).items():
        rec.check(k, v)
    rec.extra["reference_s"] = time.time() - t0
