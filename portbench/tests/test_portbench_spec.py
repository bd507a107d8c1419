"""BENCHMARK.json loads, keeps the naming rules, and every cell finds its
configuration, traffic mix and readers by name; a configuration, a mix and a
reader added from another folder are taken without editing any file."""
import json

import pytest

from portbench.harness import spec as spec_mod
from portbench.harness.spec import Spec

from conftest import ROOT

ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
}


@pytest.fixture
def data():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_benchmark_loads_with_its_keys(data):
    assert set(data) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert data["command"] == ["python3", "portbench/run.py"]
    assert data["paths"] == ["portbench"]
    assert 1 <= data["run_seconds"] <= 51
    for group, keys in ENTRY_KEYS.items():
        for entry in data[group]:
            assert set(entry) == keys, entry
    for m in data["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in data["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_names_and_units_keep_the_rules(data):
    assert spec_mod.problems(data) == []
    names = [m["name"] for m in data["end_to_end"] + data["per_layer"]]
    assert len(names) == len(set(names))
    assert spec_mod.problems({**data, "per_layer": [{**data["per_layer"][0], "name": "a b"}]})
    assert spec_mod.problems({**data, "per_layer": [{**data["per_layer"][0], "unit": "µs"}]})


def test_every_cell_finds_its_files_and_reports_what_it_must(data):
    spec = Spec()
    e2e = {m["name"] for m in data["end_to_end"]}
    for name, cell in spec.cells.items():
        cfg = spec.config(cell["config"])
        assert cfg["name"] == cell["config"]
        mix = spec.traffic(cell["traffic"])
        assert mix["loop"] in ("open", "closed")
        reported = [m["name"] for m in spec.metrics(name, False)]
        layers = spec.metrics(name, True)
        assert "setup_s" in reported and len(reported) >= 2 and layers
        for m in spec.metrics(name, False) + layers:
            assert callable(spec.reader(m["name"]))
        for m in layers:
            assert m["moves"] in reported
        rooflines = [m["moves"] for m in layers if m["name"].endswith("_roofline")
                     or "_roofline." in m["name"]]
        mfus = {m["moves"] for m in layers if "mfu" in m["name"]}
        assert set(rooflines) <= mfus


def test_a_config_mix_and_reader_from_another_folder(tmp_path, data):
    before = {p: p.read_bytes() for p in (ROOT / "portbench").rglob("*") if p.is_file()}
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "metrics").mkdir()
    cfg = json.loads((ROOT / "portbench/configs/v2.json").read_text())
    cfg["name"] = "throwaway"
    (tmp_path / "configs/throwaway.json").write_text(json.dumps(cfg))
    (tmp_path / "traffic/sparse.json").write_text(json.dumps(
        {"loop": "open", "rate_per_s": 7, "sizes": [3], "classes": "uniform", "lead_s": 0.1,
         "check_requests": 1, "client_threads": 4,
         "batcher": {"max_wait_ms": 5.0, "max_batch": 8, "pipeline_depth": 2}}))
    (tmp_path / "metrics/answer.py").write_text("def read(ctx):\n    return 42.0\n")
    bench = dict(data)
    bench["configs"] = [{"name": "throwaway", "source": "https://example.org/x",
                         "file": "configs/throwaway.json", "reduced": [], "why": "a test"}]
    bench["workloads"] = [{"name": "throwaway.sparse", "config": "throwaway",
                           "traffic": "sparse", "chips": 1, "why": "a test"}]
    bench["per_layer"] = [{"name": "answer.sparse", "unit": "1", "better": "higher",
                           "source": "host_clock", "layer": "test", "moves": "images_per_s"}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = Spec(tmp_path / "BENCHMARK.json", first=[tmp_path])
    cell = spec.cell("throwaway.sparse")
    assert spec.config(cell["config"])["name"] == "throwaway"
    assert spec.traffic(cell["traffic"])["rate_per_s"] == 7
    assert spec.reader("answer.sparse")(None) == 42.0
    assert callable(spec.reader("images_per_s"))  # the benchmark's own, found after
    after = {p: p.read_bytes() for p in (ROOT / "portbench").rglob("*") if p.is_file()}
    assert {p: b for p, b in after.items() if "__pycache__" not in str(p)} == \
        {p: b for p, b in before.items() if "__pycache__" not in str(p)}


def test_missing_names_raise(tiny_spec):
    with pytest.raises(KeyError):
        tiny_spec.cell("nope")
    with pytest.raises(FileNotFoundError):
        tiny_spec.traffic("nope")
    with pytest.raises(FileNotFoundError):
        tiny_spec.reader("nope.grid")
