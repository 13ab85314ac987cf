"""The cells' files, the traffic generator, a whole run's result line at a
tiny size on the CPU, and run.py's refusal without a card."""

import json
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import tiny
from benchmark.core import harness, traffic as gen
from benchmark.core.program import program_model, reference_model, \
    seeded_weights

SPEC = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_spec_names_and_files():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert (tiny.ROOT / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert harness.metric_file(m["name"]).is_file()
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert all("\n" not in x and len(x) <= 200 for x in layers)


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_loads_with_its_files(workload):
    cell = harness.load_cell(workload)
    assert (harness.BENCH / "drivers"
            / f"{cell['traffic']['driver']}.py").is_file()
    assert {m["name"] for m in cell["end_to_end"]} >= {"setup_s"}
    assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
    for m in cell["per_layer"]:
        assert m["moves"] in {e["name"] for e in cell["end_to_end"]}


@pytest.mark.parametrize("workload", ["r101_pyramid", "x101_pyramid"])
def test_weights_fit_the_program_and_the_reference(workload):
    config = tiny.cell(workload)["config"]
    w = seeded_weights(config, 5, torch.device("cpu"))
    assert set(w) == set(reference_model(config).state_dict())
    _, prog = program_model(config, 5, torch.device("cpu"))
    for k, v in prog.state_dict().items():
        assert torch.equal(v, w[k]), k
    again = seeded_weights(config, 5, torch.device("cpu"))
    other = seeded_weights(config, 2**31 + 11, torch.device("cpu"))
    k = "trunk.stage4_unit1.conv2_weight"
    assert torch.equal(w[k], again[k]) and not torch.equal(w[k], other[k])


def test_image_traffic_repeats_from_a_seed():
    cell = tiny.cell("r101_pyramid")
    tr, yml = cell["traffic"], cell["config"]["yml"]
    specs = gen.scale_specs(yml, tr["width"], tr["height"])
    dev = torch.device("cpu")
    a = gen.image_pool(tr, specs, 2**31 + 7, dev)
    b = gen.image_pool(tr, specs, 2**31 + 7, dev)
    c = gen.image_pool(tr, specs, 8, dev)
    assert all(torch.equal(x[0], y[0]) for x, y in zip(a, b))
    assert not torch.equal(a[0][0], c[0][0])
    r1, r2 = gen.Rounds(tr, 3), gen.Rounds(tr, 3)
    for _ in range(5):
        d = r1.next()
        assert np.array_equal(d, r2.next())
        assert len(set(d.tolist())) == tr["round_images"]


def test_flagship_scales_are_the_issues_canvases():
    cell = harness.load_cell("r101_pyramid")
    specs = gen.scale_specs(cell["config"]["yml"], 640, 480)
    assert [s["canvas"] for s in specs] == [(1408, 1920), (832, 1088),
                                           (384, 512)]
    assert [s["batch"] for s in specs] == [4, 8, 8]
    assert [s["post_nms"] for s in specs] == [300, 200, 100]


def test_chip_traffic_repeats_and_stays_in_range():
    cell = harness.load_cell("r101_train")
    tr, yml = cell["traffic"], cell["config"]["yml"]
    tr = dict(tr, n_batches=2)
    dev = torch.device("cpu")
    a, pa = gen.chip_pool(tr, yml, 2**31 + 3, dev)
    b, pb = gen.chip_pool(tr, yml, 2**31 + 3, dev)
    for x, y in zip(a, b):
        assert all(torch.equal(x[k], y[k]) for k in x)
    assert all(torch.equal(p, q) for x, y in zip(pa, pb) for p, q in zip(x, y))
    for batch in a:
        gt = batch["gt_boxes"].numpy()
        vr = batch["valid_ranges"].numpy()
        n = (gt[..., 4] >= 0).sum(1)
        assert n.min() >= 1 and n.max() <= 16
        for i in range(gt.shape[0]):
            g = gt[i, gt[i, :, 4] >= 0]
            side = np.sqrt((g[:, 2] - g[:, 0]) * (g[:, 3] - g[:, 1]))
            assert (side >= vr[i, 0] - 2).all() and (side <= vr[i, 1] + 2).all()
            assert (g[:, :4] >= 0).all() and (g[:, :4] <= 511).all()
        assert (batch["rpn_label_vals"] == 1).any()


def _load_run():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "bench_run", harness.BENCH / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("workload", ["r101_pyramid", "r101_train",
                                      "r101_serve"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_schema(workload, trace):
    run = _load_run()
    cell = tiny.cell(workload)
    res, checks = run.execute(cell, 2**31 + 5, 0.5, trace,
                              torch.device("cpu"), t_start=time.time(),
                              peak=989e12)
    keys = list(res)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"] and keys[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    want = ({m["name"] for m in cell["per_layer"]} if trace else
            {m["name"] for m in cell["end_to_end"]})
    assert set(res["metrics"]) <= want
    if not trace:
        assert set(res["metrics"]) == want
        assert all(v["value"] > 0 for v in res["metrics"].values())
    else:
        assert "breakdown" in res and {"busy_s", "window_s"} <= set(
            res["device"])
    assert set(res["checks"]) == set(cell["limits"])
    assert [k for k, _, _ in checks] == list(res["checks"])
    json.dumps(res)


def test_run_refuses_without_a_card(tmp_path):
    out = subprocess.run(
        [sys.executable, str(harness.BENCH / "run.py"), "--workload",
         "r101_pyramid", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tiny.ROOT)
    assert not torch.cuda.is_available()
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_a_split_metric_reads_as_the_metric_it_splits():
    bench = harness.BENCH / "metrics"
    assert harness.metric_file("dispatch_ms.infer") == \
        bench / "dispatch_ms.infer.py"
    assert harness.metric_file("dispatch_ms.infer.r101_pyramid") == \
        bench / "dispatch_ms.infer.py"
    assert harness.metric_file("infer_mfu.a.b") == bench / "infer_mfu.py"
    values = {"infer_img_per_s": 90.0, "infer_img_per_s.x": 7.0}
    assert harness.e2e_value(values, "infer_img_per_s.r101_pyramid") == 90.0
    assert harness.e2e_value(values, "infer_img_per_s.x") == 7.0
    with pytest.raises(KeyError):
        harness.e2e_value(values, "train_chips_per_s.r101_train")
    # the flagship's throughput is split from the other pyramids'
    spec = {m["name"]: m for m in SPEC["end_to_end"]}
    split = spec["infer_img_per_s.r101_pyramid"]
    assert split["workloads"] == ["r101_pyramid"]
    assert "r101_pyramid" not in spec["infer_img_per_s"]["workloads"]


@pytest.mark.parametrize("chips", [1, 4])
def test_result_line_counts_the_cells_cards(chips):
    run = _load_run()
    cell = tiny.cell("r101_serve")
    cell["entry"] = dict(cell["entry"], chips=chips)
    res, _ = run.execute(cell, 2**31 + 13, 0.3, False, torch.device("cpu"),
                         t_start=time.time(), peak=989e12)
    assert res["device"]["count"] == chips
