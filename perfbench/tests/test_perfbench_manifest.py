"""BENCHMARK.json against its rules, and readers found by name."""
import json
import re

import pytest

from perfbench.harness import manifest


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def test_perfbench_manifest_is_sound(bench):
    assert manifest.problems(bench) == []
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]


def test_perfbench_names_and_units_keep_to_their_characters(bench):
    for item in bench["configs"] + bench["workloads"] + \
            bench["end_to_end"] + bench["per_layer"]:
        assert re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}",
                            item["name"]), item["name"]
        for key in ("why", "layer", "source"):
            if key in item:
                assert 1 <= len(item[key]) <= 200 and "\n" not in item[key] \
                    and "\t" not in item[key], (item["name"], key)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert re.fullmatch(r"[A-Za-z0-9_/%.\-]{1,16}", m["unit"])
    assert not manifest.problems(dict(bench, end_to_end=bench["end_to_end"]))
    broken = json.loads(json.dumps(bench))
    broken["per_layer"][0]["unit"] = "tokens per s"
    broken["workloads"][0]["name"] = "a cell"
    assert len(manifest.problems(broken)) >= 2


def test_perfbench_every_moves_is_reported_in_each_of_its_cells(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or cell in moved["workloads"]
    broken = json.loads(json.dumps(bench))
    broken["per_layer"][0]["moves"] = "setup_s_typo"
    assert any("moves" in p for p in manifest.problems(broken))


def test_perfbench_configs_keep_every_width(bench):
    for c in bench["configs"]:
        cfg = json.loads((manifest.ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert not key.endswith(("_dim", "_rank", "_size")), key
            assert cfg["published"][key] != cfg["model"][key]


def test_perfbench_new_metric_file_is_found_by_name(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "brand_new.metric.py").write_text(
        "def read(run):\n    return 2.5 * run\n")
    assert manifest.reader("brand_new.metric", bench=tmp_path)(2) == 5.0


def test_perfbench_each_reader_leaves_out_what_it_cannot_read(bench):
    """A reader with nothing to read returns None, never 0."""
    from perfbench.harness.serve import Run
    run = Run(workload={}, config={"model": {}}, mix={"mode": "offline"},
              seed=0, seconds=1.0, device=None, t_process=0.0,
              t_window=(1.0, 2.0))
    for m in bench["per_layer"]:
        assert manifest.reader(m["name"])(run) is None, m["name"]
