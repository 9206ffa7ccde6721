"""U-Net training with the rasterizer in the loop.

Counterpart of ``rtnr_tpu/train/trainer.py`` on one card (its mesh and axis
arguments have no counterpart; multi-GPU waits for ``parallel``). The JAX
step functions take the flax module and the optax transform apart from the
state; here the state holds the ``UNetTrain`` module and its
``torch.optim.Adam``, so the step builders take only the render settings.
A step updates the state in place (parameters, optimizer moments,
BatchNorm running statistics, step count) and returns it with its metrics,
which stay 0-dim tensors on the state's device.

- ``make_train_step``: each frame is rendered with the serving raster and
  prefilter (``pipeline.render_filtered``: K1, K2), without gradients; the
  U-Net trains on the stacked ``unet_input``s in BatchNorm training mode.
- ``make_scene_train_step``: frames go through the differentiable raster
  (``ops.raster_diff``: K5 + K2 float sums as one kernel) and the
  prefilter, so one Adam step moves the U-Net's parameters, the point
  colours and the camera matrices together (BASELINE config 4).

Everything runs where the state lives: ``device="cuda"`` (the default)
raises without a card, ``device="cpu"`` runs the kernels' plain twins.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Sequence

import torch

from rtnr_tpu_torch.models.convert import train_state_from_flax
from rtnr_tpu_torch.models.unet import UNetTrain
from rtnr_tpu_torch.ops.prefilter import depth_prefilter
from rtnr_tpu_torch.ops.raster_diff import rasterize_diff_sorted
from rtnr_tpu_torch.pipeline import pad_to_pyramid, render_filtered


@dataclasses.dataclass
class TrainState:
    model: UNetTrain
    optimizer: torch.optim.Optimizer
    step: int = 0


@dataclasses.dataclass
class SceneTrainState:
    """Joint U-Net + scene fine-tune state: the optimizer holds the model's
    parameters, ``colors`` and ``cam_projs`` (leaf tensors)."""

    model: UNetTrain
    colors: torch.Tensor  # (N, 3) float32, 0..255 scale
    cam_projs: torch.Tensor  # (F, 4, 4) float32
    optimizer: torch.optim.Optimizer
    step: int = 0


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training on device='cuda' needs a CUDA device; "
                           "pass device='cpu' to run on the CPU")
    return dev


def _adam(params: Iterable[torch.Tensor], learning_rate: float) -> torch.optim.Adam:
    # optax.adam's defaults: b1 0.9, b2 0.999, eps 1e-8 outside the square root
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def create_train_state(variables: Dict, *, features: Optional[Sequence[int]] = None,
                       dtype: torch.dtype = torch.float32, learning_rate: float = 1e-4,
                       device="cuda") -> TrainState:
    """Raw Flax variables (nested numpy) -> a ``TrainState`` on ``device``
    with Adam at ``learning_rate``."""
    model = train_state_from_flax(variables, features=features, dtype=dtype).to(_device(device))
    return TrainState(model=model, optimizer=_adam(model.parameters(), learning_rate))


def create_scene_train_state(variables: Dict, colors, cam_projs, *,
                             features: Optional[Sequence[int]] = None,
                             dtype: torch.dtype = torch.float32,
                             learning_rate: float = 1e-4, device="cuda") -> SceneTrainState:
    """As ``create_train_state``, plus the scene's colours (N,3) and the
    frames' camera matrices (F,4,4), which one Adam updates with the net.
    Both are copied: the optimizer updates its own leaves in place, never
    the caller's arrays."""
    dev = _device(device)
    model = train_state_from_flax(variables, features=features, dtype=dtype).to(dev)
    leaf = lambda a: (torch.as_tensor(a, dtype=torch.float32).to(dev).detach().clone()
                      .requires_grad_(True))
    cols, cams = leaf(colors), leaf(cam_projs)
    opt = _adam(list(model.parameters()) + [cols, cams], learning_rate)
    return SceneTrainState(model=model, colors=cols, cam_projs=cams, optimizer=opt)


def l1_loss(pred: torch.Tensor, target: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    err = torch.abs(pred - target)
    if mask is not None:
        return torch.sum(err * mask[..., None]) / (torch.sum(mask) * pred.shape[-1] + 1e-8)
    return torch.mean(err)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: the l2 norm of all leaves together."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def _unet_loss(model: UNetTrain, x: torch.Tensor, targets: torch.Tensor, height: int,
               width: int, loss_fn: Callable) -> torch.Tensor:
    model.train()
    y = model(x).to(torch.float32)[:, :height, :width]
    return loss_fn(y, targets)


def make_train_step(*, width: int, height: int, depth_band: float = 0.02, levels: int = 4,
                    filter_strength: float = 1.025, gradient_filter: float = 0.03,
                    loss_fn: Callable = l1_loss) -> Callable:
    """step(state, points, colors, valid, cam_projs (F,4,4), targets
    (F,H,W,3) float in [0,1]) -> (state, {"loss", "grad_norm"})."""

    def step(state: TrainState, points, colors, valid, cam_projs, targets):
        with torch.no_grad():
            x = torch.stack([
                render_filtered(points, colors, valid, cam_projs[f], width=width, height=height,
                                depth_band=depth_band, levels=levels,
                                filter_strength=filter_strength,
                                gradient_filter=gradient_filter)["unet_input"]
                for f in range(cam_projs.shape[0])
            ])
        state.optimizer.zero_grad(set_to_none=True)
        loss = _unet_loss(state.model, x, targets, height, width, loss_fn)
        loss.backward()
        params = list(state.model.parameters())
        gnorm = global_norm(p.grad for p in params)
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm}

    return step


def make_scene_train_step(*, width: int, height: int, depth_band: float = 0.02,
                          levels: int = 4, filter_strength: float = 1.025,
                          gradient_filter: float = 0.03,
                          loss_fn: Callable = l1_loss) -> Callable:
    """Scene fine-tune step: gradients flow through the differentiable
    raster into point colours and camera matrices as well as the U-Net.

    step(state, points, valid, targets (F,H,W,3) in [0,1]) -> (state,
    {"loss", "grad_norm", "color_grad_norm", "pose_grad_norm"})."""

    def step(state: SceneTrainState, points, valid, targets):
        xs = []
        for f in range(state.cam_projs.shape[0]):
            out = rasterize_diff_sorted(points, state.colors, state.cam_projs[f], width=width,
                                        height=height, valid=valid, depth_band=depth_band)
            dpad, cpad = pad_to_pyramid(out.depth, out.rgb, levels)
            xs.append(depth_prefilter(dpad, cpad, levels=levels,
                                      filter_strength=filter_strength,
                                      gradient_filter=gradient_filter)["unet_input"])
        state.optimizer.zero_grad(set_to_none=True)
        loss = _unet_loss(state.model, torch.stack(xs), targets, height, width, loss_fn)
        loss.backward()
        g_params = [p.grad for p in state.model.parameters()]
        g_cols, g_cams = state.colors.grad, state.cam_projs.grad
        metrics = {
            "loss": loss.detach(),
            "grad_norm": global_norm(g_params + [g_cols, g_cams]),
            "color_grad_norm": global_norm([g_cols]),
            "pose_grad_norm": global_norm([g_cams]),
        }
        state.optimizer.step()
        state.step += 1
        return state, metrics

    return step
