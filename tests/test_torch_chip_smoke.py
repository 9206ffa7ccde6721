"""The per-kernel table of ``chip_smoke.py`` on the CPU: its rows against the
C entries of ``rtnr_tpu_torch/csrc``, a stream row's and a conv row's bound
against hand counts, the U-Net rows' work against ``rtnr_bench/flops.py`` at
1088x1920, and the limits that the script and the card tests hold kernels
to against their twins. The times, launch counts and the kernels' outputs
need the card (``python3 chip_smoke.py``)."""

import pathlib
import re

import pytest
import torch

import chip_smoke as cs
from rtnr_bench import flops
from rtnr_tpu_torch.models.convert import from_flax_variables, init_unet_numpy
from rtnr_tpu_torch.models.unet import UNet

CSRC = pathlib.Path(__file__).resolve().parents[1] / "rtnr_tpu_torch" / "csrc"
_ENTRY = re.compile(r'^(?:extern "C" )?int (rtnr_\w+)\(', re.MULTILINE)
ENTRIES = {e: f.name for f in sorted(CSRC.glob("*.cu")) for e in _ENTRY.findall(f.read_text())}
# stream sizes of a 5M-point frame at 1080p, of the order the card reads
STATS = dict(n=5_000_000, n_in=3_900_000, hw=1920 * 1080, winners=1_400_000,
             carriers=5_000_000 + 1920 * 1080, ref_in=980_000, ref_px=700_000)


@pytest.fixture(scope="module")
def unet():
    """The full-width net with the dyn plan (its weights do not enter the
    work)."""
    return UNet(from_flax_variables(init_unet_numpy(0, cs.FEATURES)), features=cs.FEATURES,
                quant_int8=True)


def test_every_c_entry_has_one_row():
    """Each C entry of the CUDA sources has exactly one row of its own (its
    other rows name a ``form``), in its source; conv.cu's, which no path at
    the benchmark's shapes launches, have none."""
    for entry, source in ENTRIES.items():
        own = [r for r in cs.ROWS if entry in r.entries and not r.form]
        forms = [r for r in cs.ROWS if entry in r.entries and r.form]
        if entry in cs.NO_PATH:
            assert not own and not forms, entry
            assert cs.NO_PATH[entry] == f"rtnr_tpu_torch/csrc/{source}"
            continue
        assert len(own) == 1, (entry, [r.name for r in own])
        for r in own + forms:
            assert r.source == f"rtnr_tpu_torch/csrc/{source}", r.name


def test_rows_name_real_entries_and_counters():
    names = [r.name for r in cs.ROWS]
    assert len(set(names)) == len(names)
    assert all(e in ENTRIES for r in cs.ROWS for e in r.entries)
    assert set(cs.launch_counts()) == set(names)
    assert cs.STANDALONE <= set(names)
    assert set(cs.NO_PATH) <= set(ENTRIES)


def test_a_stream_row_is_bound_by_its_bytes(unet):
    """The v4 resolve reads 12 B an in-frame element and writes 8 B a
    pixel: 3.9M elements and 1920x1080 pixels at 3.35 TB/s."""
    nbytes, ops = cs.row_work(unet, STATS)["resolve4"]
    assert (nbytes, ops) == (12.0 * 3_900_000 + 8.0 * 1920 * 1080, {})
    ms, by = cs.bound_ms(nbytes, ops)
    assert by == "bytes" and ms == pytest.approx(1e3 * 63_388_800 / 3.35e12, rel=1e-12)


def test_a_conv_row_is_bound_by_its_operations(unet):
    """K10 at updc3/conv0: 128 channels in (two inputs of 64), 64 out, at
    1088x1920 in bf16: 2 x 9 x 128 x 64 operations a pixel at 989 TFLOP/s,
    against its bf16 inputs, weights, f32 bias and scale and output."""
    m = 1088 * 1920
    nbytes, ops = cs.row_work(unet, STATS)["conv3x3_direct"]
    assert ops == {"bf16": 2.0 * m * 9 * 128 * 64}
    assert nbytes == 2.0 * m * 128 + 2.0 * 9 * 128 * 64 + 8.0 * 64 + 2.0 * m * 64
    ms, by = cs.bound_ms(nbytes, ops)
    assert by == "operations" and ms == pytest.approx(1e3 * 2.0 * m * 9 * 128 * 64 / 989e12,
                                                      rel=1e-12)


def _totals(items):
    ops = {}
    for c in items:
        for p, v in c["ops"].items():
            ops[p] = ops.get(p, 0.0) + v
    return ops, sum(c["bytes"] for c in items)


@pytest.mark.parametrize("mode", ["bf16", "static", "dyn", "fused"])
def test_unet_rows_sum_to_flops(unet, mode):
    """A frame's U-Net rows add up to ``flops.unet_calls`` at 1088x1920: the
    bf16 and the static frame whole; the dyn row is the ten calls its plan
    quantises, at the int8 peak; the fused-ConvTranspose row the two pairs
    of the fused levels 2 and 3, K10 updc3/conv0."""
    work = cs.unet_work(unet)
    calls = {c["name"]: c for c in flops.unet_calls(cs.FEATURES, 1088, 1920,
                                                    "static" if mode == "static" else "bf16")}
    if mode in ("bf16", "static"):
        rows = {"bf16": ("conv3x3_in", "conv3x3_wgmma", "convt2x2"),
                "static": ("conv3x3_in_i8out", "conv3x3_static", "convt2x2_static")}[mode]
        assert sum(work[r]["calls"] for r in rows) == len(calls) == 22
        got, want = _totals([work[r] for r in rows]), _totals(calls.values())
        assert got[0] == pytest.approx(want[0], rel=1e-12)
        assert got[1] == pytest.approx(want[1], rel=1e-12)
        least = sum(flops.least_s(c) for c in calls.values())
        assert sum(cs.bound_ms(work[r]["bytes"], work[r]["ops"])[0] for r in rows) <= 1e3 * least
    elif mode == "dyn":
        names = [k for k, v in unet.int8_plan(None).items() if v.get("quant") == "dyn"]
        assert len(names) == work["conv3x3_dyn"]["calls"] == 10
        ops, nbytes = _totals([calls[k] for k in names])
        assert work["conv3x3_dyn"]["ops"] == pytest.approx({"int8": ops["bf16"]}, rel=1e-12)
        assert work["conv3x3_dyn"]["bytes"] == pytest.approx(nbytes, rel=1e-12)
    else:
        assert sorted(unet.fuse_levels(1088)) == [2, 3]
        pairs = [calls[k] for i in (2, 3) for k in (f"up{i}", f"updc{i}/conv0")]
        assert work["conv3x3_up"]["calls"] == 2
        assert (work["conv3x3_up"]["ops"], work["conv3x3_up"]["bytes"]) == _totals(pairs)
        assert (work["conv3x3_direct"]["ops"], work["conv3x3_direct"]["bytes"]) == _totals(
            [calls["updc3/conv0"]])


# ---- the limits kernels are held to against their twins (also the card tests') ----

def test_same_bits_tells_signed_zeros_nans_and_shapes_apart():
    z = torch.zeros(4)
    nan = torch.full((4,), float("nan"))
    assert cs.same_bits([z, nan], [z.clone(), nan.clone()])
    assert not cs.same_bits([z], [-z])
    assert not cs.same_bits([z], [z, z])
    assert not cs.same_bits([z], [z[:3]])
    assert cs.same_bits([torch.arange(4)], [torch.arange(4)])
    assert not cs.same_bits([torch.arange(4)], [torch.arange(1, 5)])


def test_within_ulp2_is_two_bf16_ulp_of_the_twins_magnitude():
    """At |twin| max 3 (exponent 1) two bf16 ulp are 2^-5."""
    want = torch.tensor([3.0, -1.0, 0.25])
    assert cs.ulp2(want) == 2.0 ** -5
    assert cs.within_ulp2(want + 2.0 ** -5, want)
    assert not cs.within_ulp2(want + 2.0 ** -5 + 2.0 ** -12, want)
    assert cs.within_ulp2(want.to(torch.bfloat16), want)


def test_codes_within_one_on_a_thousandth_of_the_elements():
    want = torch.zeros(2500, dtype=torch.int8)
    got = want.clone()
    got[:2] = 1
    assert cs.codes_within_one(got, want)
    got[2] = -1
    assert not cs.codes_within_one(got, want)
    got[1:3] = 0
    got[5] = 2
    assert not cs.codes_within_one(got, want)


def test_winners_ok_reads_the_rows_up_to_the_total():
    rows = torch.arange(6 * 8, dtype=torch.int32).reshape(6, 8)
    other = rows.clone()
    other[:, 5:] = -1  # past the total: never read
    total = torch.tensor([5], dtype=torch.int32)
    assert cs.winners_ok((other, total), (rows, total))
    other[3, 4] = 0
    assert not cs.winners_ok((other, total), (rows, total))
    assert not cs.winners_ok((rows, total + 1), (rows, total))
