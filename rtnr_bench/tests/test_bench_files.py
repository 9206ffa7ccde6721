"""A cell, a configuration, a traffic mix and a metric added as files
only are found and run; the command refuses without a card or without the
program beside it."""

import json
import os
import shutil
import subprocess
import sys

from rtnr_bench import harness
from rtnr_bench.tests.conftest import ROOT


def test_added_files_are_found(tiny_root, one_thread):
    b = tiny_root / "rtnr_bench"
    cfg = json.loads((b / "configs" / "building50m-int8-1080p.json").read_text())
    cfg["name"] = "smallhouse-int8"
    cfg["scene"]["grid"] = [2, 1]
    (b / "configs" / "smallhouse-int8.json").write_text(json.dumps(cfg))
    t = json.loads((b / "traffic" / "walk.json").read_text())
    t["loop"] = [[0, 0], [1, 0]]
    (b / "traffic" / "shortwalk.json").write_text(json.dumps(t))
    (b / "metrics" / "recompute_share.py").write_text(
        "def read(run):\n"
        "    f = run.frames\n"
        "    return 100.0 * sum(x['recomputed'] for x in f) / len(f) if f else None\n")
    m = json.loads((tiny_root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "smallhouse-int8", "source": "https://example.org/house",
                         "file": "rtnr_bench/configs/smallhouse-int8.json", "reduced": [],
                         "why": "two rooms"})
    m["workloads"].append({"name": "smallhouse-int8.shortwalk", "config": "smallhouse-int8",
                           "traffic": "shortwalk", "chips": 1, "why": "a short walk"})
    m["per_layer"].append({"name": "recompute_share", "unit": "%", "better": "lower",
                           "source": "program_counter", "layer": "Culling", "moves": "fps",
                           "workloads": ["smallhouse-int8.shortwalk"]})
    m["end_to_end"][0]["workloads"].append("smallhouse-int8.shortwalk")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(m))
    out = harness.execute(["--workload", "smallhouse-int8.shortwalk", "--seed", "5",
                           "--seconds", "0.5", "--trace", "1"], root=tiny_root, device="cpu")
    assert out["correct"] is True
    assert 0 <= out["metrics"]["recompute_share"]["value"] <= 100
    assert "stage.unet_ms" not in out["metrics"]  # listed for the walk cell only
    e2e = harness.execute(["--workload", "smallhouse-int8.shortwalk", "--seed", "5",
                           "--seconds", "0.5", "--trace", "0"], root=tiny_root, device="cpu")
    assert set(e2e["metrics"]) == {"fps", "setup_s"}
    assert list(e2e)[-1] == "checks"


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable] + args, cwd=cwd, capture_output=True, text=True,
                          timeout=120, env=env)


def test_command_refuses_without_a_card():
    p = _run(["rtnr_bench/run.py", "--workload", "room5m-train-1080p.steps", "--seed", "1",
              "--seconds", "1", "--trace", "0"], ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "rtnr_bench", tmp_path / "rtnr_bench")
    code = ("import sys; sys.path[:0] = ['.']; from rtnr_bench import harness; "
            "harness.execute(['--workload', 'room5m-train-1080p.steps', '--seed', '1', "
            "'--seconds', '1'], root='.', device='cpu'); print('{}')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = _run(["-c", code], tmp_path, env)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "rtnr_tpu_torch" in p.stderr
