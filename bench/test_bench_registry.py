"""The harness finds every part of every cell by name, and
`BENCHMARK.json` keeps to the shape its contract asks for."""
import json
import re

import pytest

from benchkit import registry

SPEC = registry.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_found_by_name(cell):
    parts = registry.find(SPEC, cell)
    assert parts["cell"]["name"] == cell
    assert parts["config"]["name"] == parts["config_name"]
    for fn in ("make_inputs", "setup", "window", "check", "control"):
        assert callable(getattr(parts["driver"], fn)), fn
    ref = registry.load_reference(parts["config_name"])
    assert ref.__doc__
    limits = parts["traffic"]["limits"]
    assert all(isinstance(v, (int, float)) for v in limits.values())


@pytest.mark.parametrize("cell", CELLS)
def test_every_metric_of_a_cell_has_a_reader(cell):
    per_layer = registry.metrics_for(SPEC, "per_layer", cell)
    assert per_layer
    for m in per_layer:
        assert callable(registry.load_metric(m["name"]).read)
    e2e = {m["name"] for m in registry.metrics_for(SPEC, "end_to_end", cell)}
    assert {"setup_s", "peak_mem_gib"} <= e2e and len(e2e) >= 3


def test_spec_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(SPEC)) < 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [c["name"] for c in SPEC["configs"]]
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(SPEC["paths"][0] + "/")
        assert c["name"] in {w["config"] for w in SPEC["workloads"]}
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(SPEC["workloads"])
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert "bound" not in m
    everything = (names + CELLS + [m["name"] for m in SPEC["end_to_end"]]
                  + [m["name"] for m in SPEC["per_layer"]])
    assert len(everything) == len(set(everything))
    assert all(NAME.match(n) for n in everything)


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        registry.workload(SPEC, "no-such-cell")
    with pytest.raises(ValueError):
        registry.load_traffic("../BENCHMARK")
    with pytest.raises(FileNotFoundError):
        registry.load_metric("no_such_metric")
    with pytest.raises(FileNotFoundError):
        registry.load_metric("no_such_metric.det")


def test_a_suffixed_metric_falls_back_to_its_shared_reader():
    shared = registry.load_metric("idle_share")
    assert registry.load_metric("idle_share.det") is shared
    assert registry.load_metric("idle_share.any_later_cell") is shared


def _detector_at_other_fractions():
    from benchkit import sweeps
    cfg = registry.find(SPEC, "det-proposed-all")["config"]
    sweeps.detector(dict(cfg, ternary_fractions=[0.1, 0.8, 0.1]))


def _fractions_not_summing_to_one():
    from benchkit import sweeps
    cfg = registry.find(SPEC, "layer-macro-all")["config"]
    sweeps.ternary_fractions(dict(cfg, ternary_fractions=[0.2, 0.5, 0.2]))


def _program_on_another_threefry():
    from benchkit import sweeps
    cfg = registry.find(SPEC, "layer-macro-all")["config"]
    sweeps.threefry_scheme(dict(cfg, threefry="original"))


def _reference_on_another_threefry():
    from reference import irc
    cfg = registry.find(SPEC, "layer-macro-all")["config"]
    irc.scheme(dict(cfg, threefry="original"))


@pytest.mark.parametrize("ask", [_detector_at_other_fractions,
                                 _fractions_not_summing_to_one,
                                 _program_on_another_threefry,
                                 _reference_on_another_threefry],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_configuration_that_cannot_be_followed_is_refused(ask):
    with pytest.raises(ValueError):
        ask()
