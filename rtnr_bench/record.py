"""What the metric readers share: the U-Net calls of a run's configuration
and the traced window's idle share."""

from __future__ import annotations

from typing import Dict, List, Optional

from rtnr_bench import flops


def _padded(run, levels: int):
    m = 1 << levels
    cam = run.config["camera"]
    return -(-cam["height"] // m) * m, -(-cam["width"] // m) * m


def serve_calls(run) -> List[Dict]:
    """The serving U-Net's calls of one frame at the padded frame size, in
    its configured mode (static int8 or exact bf16)."""
    rc = run.config["render"]
    h, w = _padded(run, rc["pyramid_levels"])
    mode = "static" if rc["unet_int8"] == "static" else "bf16"
    return flops.unet_calls(rc["unet_features"], h, w, mode)


def train_calls(run) -> List[Dict]:
    """The training U-Net's forward calls of one step's frames, in bf16."""
    tc = run.config["train"]
    h, w = _padded(run, tc["pyramid_levels"])
    return flops.unet_calls(tc["unet_features"], h, w, "bf16") * int(tc.get("batch", 1))


def idle_share(run) -> Optional[float]:
    t = run.traced
    if not t or not t.get("window_s") or not t.get("busy_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
