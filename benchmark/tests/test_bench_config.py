"""A configuration brings its own reference and names its judged maps:
the harness judges by the class the configuration names, refuses before
set-up a viewer knob that the class does not model, and judges a map
kept from each frame's graph pool as it judges one read at set-up."""

import copy
import json
import os
import subprocess
import sys

import pytest
import torch

from gbench.cell import ConfigError, compare, reference_for, run_cell
from test_bench_reference import SEED, _wrap_pass, small, verdict

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def quiet(*a):
    pass


@pytest.fixture(scope="module")
def forward():
    """A small forward_pcf run, its sun map judged through set-up."""
    torch.set_num_threads(2)
    cfg, tr = small("forward_pcf", "walk_1080p")
    res = run_cell(cfg, tr, SEED, 0.5, False, "cpu", log=quiet)
    return cfg, tr, res, compare(res, cfg, "cpu", log=quiet)


def test_configuration_names_the_reference(forward):
    """(a) The stub class the configuration names judges the run: its
    lit HDR is off at every pixel; the rest reads as plainref's."""
    cfg, _tr, res, plain = forward
    stub = copy.deepcopy(cfg)
    stub["reference"] = "stub_reference:ScaledReference"
    out = compare(res, stub, "cpu", log=quiet)
    assert verdict(cfg, plain["numbers"]), plain["numbers"]
    assert out["numbers"]["hdr"] == 1.0
    assert out["numbers"]["hdr_fine"] == 1.0
    for k in ("geometry", "sun_depth"):
        assert out["numbers"][k] == plain["numbers"][k]
    assert type(out["ref"]).__name__ == "ScaledReference"


def frame_sun(cfg):
    cfg = copy.deepcopy(cfg)
    cfg["reference"] = "stub_reference:FrameSunReference"
    cfg["judged_maps"] = {"sun_depth": "frame:shadow-depth"}
    return cfg


def shadow_block_altered(app):
    """A block of the sun map altered where the shadow pass produces it."""
    def change(outs):
        depth = outs["shadow-depth"].clone()
        depth[:32, :32] += 0.25
        return {**outs, "shadow-depth": depth}
    _wrap_pass(app, "shadow-main", change)


def test_frame_map_reads_as_the_setup_map(forward):
    """(c) The sun map kept from each judged frame's pool reads the same
    sun_depth as the set-up route; altered in the pool, it is not
    correct."""
    cfg, tr, _res, plain = forward
    fcfg = frame_sun(cfg)
    res = run_cell(fcfg, tr, SEED, 0.5, False, "cpu", log=quiet)
    assert all(j["maps"]["sun_depth"] is not None
               for j in res["judged"].values())
    out = compare(res, fcfg, "cpu", log=quiet)
    assert out["numbers"]["sun_depth"] == plain["numbers"]["sun_depth"]
    assert all("sun_depth" in d["numbers"] for d in out["detail"].values())
    assert verdict(fcfg, out["numbers"]), out["numbers"]
    bad = run_cell(fcfg, tr, SEED, 0.5, False, "cpu",
                   fault=shadow_block_altered, log=quiet)
    num = compare(bad, fcfg, "cpu", log=quiet)["numbers"]
    assert num["sun_depth"] > fcfg["limits"]["sun_depth"], num
    assert not verdict(fcfg, num)


def test_knob_values_are_typed():
    """A knob's value is modelled only as written: true is not 1."""
    cfg, _tr = small("forward_pcf", "walk_1080p")
    reference_for(cfg)
    for knob, value in (("msaa", True), ("hdrBloom", 1)):
        bad = copy.deepcopy(cfg)
        bad["viewer"][knob] = value
        with pytest.raises(ConfigError, match=knob):
            reference_for(bad)


def checkout(tmp_path, configs: dict):
    """A checkout of the benchmark with these configurations, each the
    config of one cell named after it."""
    bench = tmp_path / "benchmark"
    (bench / "configs").mkdir(parents=True)
    for d in ("gbench", "plainref", "gref", "traffic", "metrics"):
        (bench / d).symlink_to(os.path.join(BENCH, d))
    (bench / "run.py").write_text(open(os.path.join(BENCH, "run.py")).read())
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"], spec["workloads"] = [], []
    for name, cfg in configs.items():
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        spec["configs"].append({"name": name, "source": "test",
                                "file": f"benchmark/configs/{name}.json",
                                "reduced": [], "why": "test"})
        spec["workloads"].append({"name": f"{name}.orbit", "config": name,
                                  "traffic": "orbit_1080p", "chips": 1,
                                  "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path


def base_config():
    with open(os.path.join(BENCH, "configs", "forward_pcf.json")) as f:
        return json.load(f)


def with_knob(knob, value):
    cfg = base_config()
    cfg["viewer"][knob] = value
    return cfg


def without_reference():
    cfg = base_config()
    del cfg["reference"]
    return cfg


def with_reference(spec):
    cfg = base_config()
    cfg["reference"] = spec
    return cfg


REFUSED = {
    "cascaded": (with_knob("directionalLightShadowsCascaded", True),
                 "directionalLightShadowsCascaded"),
    "pcf_wide": (with_knob("PCFKernelWide", True), "PCFKernelWide"),
    "vsm_atlas": (with_knob("clusteredLightsShadowsVSM", True),
                  "clusteredLightsShadowsVSM"),
    "ui": (with_knob("showUi", True), "showUi"),
    "msaa4": (with_knob("msaa", 4), "msaa"),
    "taa": (with_knob("postAA", "taa"), "postAA"),
    "no_reference": (without_reference(), '"reference"'),
    "no_class": (with_reference("plainref.frame:NoSuchFrame"),
                 "NoSuchFrame"),
    "no_module": (with_reference("plainref.nosuch:ReferenceFrame"),
                  "plainref.nosuch"),
}


@pytest.fixture(scope="module")
def refusals(tmp_path_factory):
    """run.py on each configuration, where no card is visible: a refusal
    comes before the look for the card (exit 2), a configuration that
    passes the check reaches it (exit 3)."""
    configs = {name: cfg for name, (cfg, _w) in REFUSED.items()}
    configs["as_written"] = base_config()
    root = checkout(tmp_path_factory.mktemp("checkout"), configs)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = {}
    for name in configs:
        out[name] = subprocess.run(
            [sys.executable, str(root / "benchmark" / "run.py"),
             "--workload", f"{name}.orbit", "--seed", str(2**31 + 5),
             "--seconds", "1", "--trace", "0"],
            capture_output=True, text=True, timeout=300, cwd=root, env=env)
    return out


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_run_refuses_before_setup(refusals, name):
    """(b) Refused before set-up, with no result and the knob (or the
    reference) named."""
    run = refusals[name]
    word = REFUSED[name][1]
    assert run.returncode == 2, run.stderr[-2000:]
    assert run.stdout.strip() == ""
    assert word in run.stderr, run.stderr[-2000:]
    if name not in ("no_reference", "no_class", "no_module"):
        assert "plainref.frame:ReferenceFrame" in run.stderr


def test_run_checks_then_looks_for_the_card(refusals):
    run = refusals["as_written"]
    assert run.returncode == 3 and run.stdout.strip() == "", \
        run.stderr[-2000:]
