"""The harness finds each configuration, traffic mix, limits file and metric
by the names BENCHMARK.json gives, so a later change adds a cell or a metric
as new files only."""

import json
import shutil

from benchmark import check, drive, run


def _spec():
    return json.loads((run.ROOT / "BENCHMARK.json").read_text())


def test_every_cell_finds_its_files():
    spec = _spec()
    for w in spec["workloads"]:
        cell = run.load_cell(w["name"])
        assert cell.traffic["kind"] in drive.DRIVERS and cell.traffic["kind"] in check.CHECKS
        assert set(cell.limits["limits"]) and 0 < cell.limits["ladder"]["c"][0] <= 1 <= cell.limits["ladder"]["c"][1]
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(run.load_reader(m["name"]))


def test_a_new_cell_and_metric_are_new_files_only(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(run.HERE, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    spec = _spec()
    spec["workloads"].append({"name": "rgp1-rollout-w64", "config": "rgp1-actuator-M100", "traffic": "rollout-w64",
                              "chips": 1, "why": "a narrow rollout"})
    spec["per_layer"].append({"name": "requests_per_s.rollout", "unit": "1/s", "better": "higher",
                              "source": "host_clock", "layer": "loop", "moves": "rollout_steps_per_s",
                              "workloads": ["rgp1-rollout-w64"]})
    next(m for m in spec["end_to_end"] if m["name"] == "rollout_steps_per_s")["workloads"].append("rgp1-rollout-w64")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    traffic = json.loads((run.HERE / "traffic" / "rollout-w1024.json").read_text())
    traffic["width"] = 64
    (root / "benchmark" / "traffic" / "rollout-w64.json").write_text(json.dumps(traffic))
    (root / "benchmark" / "limits" / "rgp1-rollout-w64.json").write_text(
        (run.HERE / "limits" / "rgp2mlp-rollout-w1024.json").read_text())
    (root / "benchmark" / "metrics" / "requests_per_s.rollout.py").write_text(
        "def read(ctx):\n    return ctx.window.steps / ctx.window.seconds\n")

    cell = run.load_cell("rgp1-rollout-w64", root=root)
    assert cell.config["name"] == "rgp1-actuator-M100" and cell.traffic["width"] == 64
    assert [m["name"] for m in cell.per_layer] == ["requests_per_s.rollout"]
    assert [m["name"] for m in cell.end_to_end] == ["rollout_steps_per_s", "setup_s"]
    assert run.load_reader("requests_per_s.rollout", cell.here)(
        type("C", (), {"window": drive.Window(2.0, 0, 10, [], 0, {}, None, 0)})) == 5.0
