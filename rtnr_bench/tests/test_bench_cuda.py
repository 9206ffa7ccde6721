"""On the card: both cells at the tiny size through the hand-written
kernels, correct against the reference; skipped without a card.

    python -m pytest -m cuda rtnr_bench/tests/test_bench_cuda.py
"""

import pytest

from rtnr_bench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["building50m-int8-1080p.walk", "room5m-train-1080p.steps"])
def test_tiny_cells_on_the_card(tiny_root, cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = harness.execute(["--workload", cell, "--seed", "21", "--seconds", "1", "--trace", "1"],
                          root=tiny_root, device="cuda")
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
    assert out["breakdown"]["device_ops"]
