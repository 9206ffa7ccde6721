"""U-Net training with the rasterizer in the loop.

Counterpart of ``rtnr_tpu/train/trainer.py``. The JAX step functions take
the flax module and the optax transform apart from the state; here the state
holds the ``UNetTrain`` module and its ``torch.optim.Adam``, so the step
builders take only the render settings and, for several ranks, the mesh.
A step updates the state in place (parameters, optimizer moments,
BatchNorm running statistics, step count) and returns it with its metrics,
which stay 0-dim tensors on the state's device.

- ``make_train_step``: each frame is rendered with the serving raster and
  prefilter (``parallel.render_filtered_sharded``, over one rank
  ``pipeline.render_filtered``'s ops: K1, K2), without gradients; the
  U-Net trains on the stacked ``unet_input``s in BatchNorm training mode.
- ``make_scene_train_step``: frames go through the differentiable raster
  (``ops.raster_diff``: K5 + K2 float sums as one kernel) and the
  prefilter, so one Adam step moves the U-Net's parameters, the point
  colours and the camera matrices together (BASELINE config 4).

Everything runs where the state lives: ``device="cuda"`` (the default)
raises without a card, ``device="cpu"`` runs the kernels' plain twins.

Both steps run one code path over a mesh; without one (``mesh=None``) it is
this rank alone, every axis of size 1, where each collective is the identity
and the step is the serial one. With ``mesh`` (``parallel.make_mesh``; every
rank runs the step, SPMD): the
points, colours and ``valid`` a rank passes are its block on the points
axis, ``cam_projs`` and ``targets`` hold all F frames and the rank trains on
its F / n_batch of them (``parallel/render.py``'s contract). The loss is the
mean over the global batch; BatchNorm's statistics are the global batch's
(``UNetTrain.sync_batch_stats``); the U-Net's gradients are summed over the
batch axis before Adam, so the parameters and the optimizer state stay
replicated, equal bit for bit on every rank. The scene step rasters through
``parallel/diff.py``: a rank's ``state.colors`` is its block of colours,
whose gradient sums over every frame there, and ``state.cam_projs`` (F, 4, 4)
is replicated, its gradient merged over both axes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import torch

from rtnr_tpu_torch.models.convert import train_state_from_flax
from rtnr_tpu_torch.models.unet import UNetTrain
from rtnr_tpu_torch.ops.prefilter import filter_frame
from rtnr_tpu_torch.parallel.collectives import psum, shard_rows
from rtnr_tpu_torch.parallel.diff import rasterize_diff_sharded_batch
from rtnr_tpu_torch.parallel.mesh import Mesh, make_mesh
from rtnr_tpu_torch.parallel.render import render_filtered_sharded
from rtnr_tpu_torch.utils import trace


def _mesh(mesh: Optional[Mesh], batch_axis: str, points_axis: str) -> Mesh:
    """The steps' mesh: without one, this rank alone (every axis of size 1,
    so every collective below is the identity)."""
    return make_mesh((1, 1), (batch_axis, points_axis)) if mesh is None else mesh


def _sum_grads(params: List[torch.Tensor], mesh: Mesh, axis: str) -> None:
    """Every parameter's gradient summed over ``axis`` (one collective of the
    flattened gradients), in place."""
    if mesh.size(axis) == 1:
        return
    flat = psum(torch.cat([p.grad.reshape(-1) for p in params]), mesh, axis)
    o = 0
    for p in params:
        p.grad.copy_(flat[o:o + p.numel()].view_as(p.grad))
        o += p.numel()


def _global_loss(loss: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The mean of every rank's local loss over ``axis`` (equal local
    batches)."""
    return psum(loss.reshape(1), mesh, axis)[0] / mesh.size(axis)


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
                    loss_fn: Callable = l1_loss, mesh: Optional[Mesh] = None,
                    points_axis: str = "points", batch_axis: str = "batch") -> Callable:
    """step(state, points, colors, valid, cam_projs (F,4,4), targets
    (F,H,W,3) float in [0,1]) -> (state, {"loss", "grad_norm"}). ``mesh``:
    several ranks (module doc). Each call is one step of the record
    (``utils.trace``): the root span ``step`` holds ``step.render`` (the
    raster and prefilter), ``step.forward`` (``zero_grad``, the BatchNorm
    sync, the U-Net and the loss), ``step.backward`` and ``step.optimizer``
    (the gradient sum, ``global_norm``, Adam)."""
    mesh = _mesh(mesh, batch_axis, points_axis)

    def step(state: TrainState, points, colors, valid, cam_projs, targets):
        with trace.span("step", root=True, device=points.device):
            with trace.span("step.render"), torch.no_grad():
                x = render_filtered_sharded(
                    points, colors, valid, cam_projs, mesh, width=width, height=height,
                    depth_band=depth_band, levels=levels, filter_strength=filter_strength,
                    gradient_filter=gradient_filter, points_axis=points_axis,
                    batch_axis=batch_axis)["unet_input"]
            with trace.span("step.forward"):
                state.optimizer.zero_grad(set_to_none=True)
                state.model.sync_batch_stats(mesh, batch_axis)
                loss = _unet_loss(state.model, x, shard_rows(targets, mesh, batch_axis), height,
                                  width, loss_fn)
            with trace.span("step.backward"):
                (loss / mesh.size(batch_axis)).backward()
            with trace.span("step.optimizer"):
                params = list(state.model.parameters())
                _sum_grads(params, mesh, batch_axis)
                gnorm = global_norm(p.grad for p in params)
                state.optimizer.step()
            state.step += 1
            return state, {"loss": _global_loss(loss.detach(), mesh, batch_axis),
                           "grad_norm": gnorm}

    return step


def make_scene_train_step(*, width: int, height: int, depth_band: float = 0.02,
                          levels: int = 4, filter_strength: float = 1.025,
                          gradient_filter: float = 0.03, loss_fn: Callable = l1_loss,
                          mesh: Optional[Mesh] = None, points_axis: str = "points",
                          batch_axis: str = "batch") -> Callable:
    """Scene fine-tune step: gradients flow through the differentiable
    raster into point colours and camera matrices as well as the U-Net.

    step(state, points, valid, targets (F,H,W,3) in [0,1]) -> (state,
    {"loss", "grad_norm", "color_grad_norm", "pose_grad_norm"}). ``mesh``:
    several ranks (module doc)."""
    mesh = _mesh(mesh, batch_axis, points_axis)

    def prefiltered(depth, rgb):
        return filter_frame(depth, rgb, levels=levels, filter_strength=filter_strength,
                            gradient_filter=gradient_filter)["unet_input"]

    def step(state: SceneTrainState, points, valid, targets):
        out = rasterize_diff_sharded_batch(
            points, state.colors, state.cam_projs, mesh, width=width, height=height,
            valid=valid, depth_band=depth_band, points_axis=points_axis, batch_axis=batch_axis)
        xs = [prefiltered(out.depth[f], out.rgb[f]) for f in range(out.depth.shape[0])]
        state.model.sync_batch_stats(mesh, batch_axis)
        state.optimizer.zero_grad(set_to_none=True)
        loss = _unet_loss(state.model, torch.stack(xs), shard_rows(targets, mesh, batch_axis),
                          height, width, loss_fn)
        (loss / mesh.size(batch_axis)).backward()
        params = list(state.model.parameters())
        _sum_grads(params, mesh, batch_axis)
        g_params = [p.grad for p in params]
        g_cols, g_cams = state.colors.grad, state.cam_projs.grad
        # the colours are split over the points axis
        col_sq = psum(torch.sum(g_cols * g_cols).reshape(1), mesh, points_axis)[0]
        sq = sum(torch.sum(g * g) for g in g_params) + col_sq + torch.sum(g_cams * g_cams)
        metrics = {
            "loss": _global_loss(loss.detach(), mesh, batch_axis),
            "grad_norm": torch.sqrt(sq),
            "color_grad_norm": torch.sqrt(col_sq),
            "pose_grad_norm": global_norm([g_cams]),
        }
        state.optimizer.step()
        state.step += 1
        return state, metrics

    return step
