"""BENCHMARK.json and the files it names: every cell's configuration,
mix, limits and per-layer readers are found by name, and the file keeps
to the benchmark contract's shapes."""

import json
import os
import re

import pytest

from benchmark.harness import spec

ROOT = spec.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    seen = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert c["reduced"] == []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["name"] not in seen
        seen.add(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for w in m["workloads"]:  # each cell it lists reports what it moves
            moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
            assert w in moved.get("workloads", CELLS)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("workload", CELLS)
def test_cell_found_by_name(workload):
    cell = spec.load(workload)
    assert cell.chips == 1
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(cell.readers[m["name"]])
    for k in ("meta_mismatch", "seq_err", "rec_err", "score_gap_max"):
        assert "limit" in cell.limits[k]


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_matches_the_program(name):
    """The configuration's widths are the program's model at that key."""
    from flappie_tpu_torch.models.config import get_model_config

    cfg = json.load(open(os.path.join(ROOT, f"benchmark/configs/{name}.json")))
    model = get_model_config(cfg["model"])
    w = cfg["widths"]
    assert [(c.winlen, c.in_ch, c.out_ch, c.stride, c.activation) for c in model.convs] == \
        [(c["winlen"], c["in_ch"], c["out_ch"], c["stride"], c["activation"]) for c in w["convs"]]
    assert [(r.kind, r.size, r.backward) for r in model.rnns] == \
        [(r["kind"], r["size"], r["backward"]) for r in w["rnns"]]
    assert (model.head, model.nbase) == (w["head"], w["nbase"])
    assert cfg["decode"]["chunk_samples"] == 2560 * model.total_stride


def test_a_new_metric_file_is_found(tmp_path, monkeypatch):
    metrics = tmp_path / "metrics"
    metrics.mkdir()
    (metrics / "x_share.offline.py").write_text("def read(ctx):\n    return 42.0\n")
    monkeypatch.setattr(spec, "BENCH_DIR", str(tmp_path))
    assert spec.reader("x_share.offline")(None) == 42.0


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load("no_such_model.offline")


@pytest.mark.parametrize("workload", CELLS)
def test_loop_law_and_reference_found_by_name(workload):
    """The modules a cell's files name: its mix's loop and read-length
    law, its configuration's reference, each with what the harness
    calls."""
    cell = spec.load(workload)
    loop = spec.module("loops", cell.traffic["loop"]).Loop
    for name in ("warm", "window", "traced_stretch", "sample", "records", "close"):
        assert callable(getattr(loop, name)), name
    assert callable(spec.module("laws", cell.traffic["reads"]["law"]).draw)
    fam = spec.module("reference", cell.config["reference"])
    for name in ("make_params", "checkpoint", "records"):
        assert callable(getattr(fam, name)), name
    with pytest.raises(KeyError):
        spec.module("loops", "../harness")
