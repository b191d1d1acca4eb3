"""The harness on the CPU: parts found by name from files alone, the
result line, the refusal without a card, one more configuration, cell and
metric added by files alone, no JAX loaded, and the trace's reading."""

import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import tiny
from ltbench import harness, tracing
from ltbench.registry import Registry

REPO = tiny.REPO
SEED = 2**31 + 977  # past what 32 signed bits hold
CELL = "soft_shadow_123k.frames_d3"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def test_every_part_is_found_by_name():
    reg = Registry(REPO)
    b = reg.benchmark
    for c in b["configs"]:
        cfg = reg.config(c["name"])
        assert cfg["name"] == c["name"]
        reg.module("reference", cfg["reference"])
        for shape in cfg["shapes"]:
            assert callable(reg.module("shapes", shape["shape"]).triangles)
    for w in b["workloads"]:
        traffic = reg.traffic(w["traffic"])
        reg.module("entries", traffic["entry"])
        assert set(reg.workload(w["name"])["limits"]) == {"pixels_off",
                                                          "gap_p95"}
    for kind in ("end_to_end", "per_layer"):
        for m in b[kind]:
            assert callable(reg.module("metrics", m["name"]).read)
    for name, spec, mod, attr in tracing._targets(reg.spans()):
        assert callable(getattr(mod, attr)), name


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(root, trace):
    res = harness.run(root, CELL, SEED, 0.3, bool(trace), device="cpu")
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] * trace + ["check"]
    assert list(res) == keys
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    json.loads(json.dumps(res))
    reg = Registry(root)
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in reg.metrics_of(CELL, kind)}
    # a CPU run has no device trace, sync count or peak: those readers
    # find nothing and their metrics are left out
    got = set(res["metrics"])
    assert got <= want
    if trace:
        assert {"api_host_ms_per_frame", "scene_build_s"} <= got
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(res["device"])
    else:
        assert got == want
    for k, v in res["check"].items():
        assert v["value"] <= v["limit"], k


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, str(REPO / "ltbench" / "run.py"),
                        "--workload", CELL, "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       env=env, cwd=REPO, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_one_more_of_each_by_files_alone(tmp_path):
    root = tiny.make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    before = _digest(root / "ltbench")
    base = root / "ltbench"
    cfg = tiny.tiny_config("soft_shadow_123k")
    cfg.update(name="second_sphere", camera=[0.5, 1.0, 6.0])
    (base / "configs" / "second_sphere.json").write_text(json.dumps(cfg))
    traffic = json.loads((base / "traffic" / "frames_d3.json").read_text())
    traffic["render"]["max_depth"] = 2
    (base / "traffic" / "frames_d2.json").write_text(json.dumps(traffic))
    (base / "workloads" / "second_sphere.frames_d2.json").write_text(
        (base / "workloads" / f"{CELL}.json").read_text())
    (base / "metrics" / "frames_in_window.py").write_text(
        "def read(record):\n    return len(record['job_s'])\n")
    bench["configs"].append({"name": "second_sphere", "source": "x",
                             "file": "ltbench/configs/second_sphere.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "second_sphere.frames_d2",
                               "config": "second_sphere",
                               "traffic": "frames_d2", "chips": 1,
                               "why": "x"})
    bench["end_to_end"].append({"name": "frames_in_window", "unit": "frames",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["second_sphere.frames_d2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = harness.run(root, "second_sphere.frames_d2", SEED, 0.3, False,
                      device="cpu")
    assert res["correct"] is True
    assert res["metrics"]["frames_in_window"]["value"] == res["attempted"]
    after = _digest(base)
    assert {k: after[k] for k in before} == before


def test_no_jax_module_is_loaded(root):
    code = f"""
import sys
sys.path.insert(0, {str(REPO)!r})
sys.path.insert(0, {str(REPO / 'ltbench' / 'run.py')!r}.rsplit('/', 1)[0])
import run
from ltbench import harness
harness.run({str(root)!r}, {CELL!r}, 5, 0.2, True, device="cpu")
print(run.forbidden_modules())
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600,
                       env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_reference_loads_nothing_of_the_program(root):
    code = f"""
import sys
sys.path.insert(0, {str(REPO)!r})
from ltbench.registry import Registry
from ltbench.scene import scene_arrays, render_settings
reg = Registry({str(root)!r})
cell = reg.cell({CELL!r})
cfg = reg.config(cell["config"])
ref = reg.module("reference", cfg["reference"])
arrays = scene_arrays(reg, cfg)
scene = ref.build(arrays, "cpu")
px = ref.render_pixels(scene, render_settings(cfg, reg.traffic(cell["traffic"])), 3, [0, 5, 77])
print(tuple(px.shape), sorted({{m.split(".")[0] for m in sys.modules}}
      & {{"jax", "jaxlib", "flax", "light_transport_tpu",
          "light_transport_tpu_torch"}}))
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "(3, 3) []"


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def test_trace_reading():
    spans = {"dispatch.scene_intersect": {"group": "dispatch"},
             "intersect_kernel.intersect_gather": {
                 "group": "isect_kernel",
                 "kernels": ["intersect_gather_kernel"]}}
    events = [
        _ev("user_annotation", tracing.JOB_SPAN, 0, 1000),
        _ev("user_annotation", "dispatch.scene_intersect", 100, 500),
        _ev("user_annotation", "intersect_kernel.intersect_gather", 200,
            100),
        _ev("cuda_runtime", "cudaLaunchKernel", 150, 5, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 250, 5, corr=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 700, 5, corr=3),
        _ev("cpu_op", "aten::nonzero", 400, 300),
        _ev("kernel", "void at::native::sort_kernel<float>(float*)", 160, 40,
            tid=7, corr=1),
        _ev("kernel", "(anonymous namespace)::intersect_gather_kernel("
            "float const*, int)", 260, 300, tid=7, corr=2),
        _ev("gpu_memcpy", "Memcpy DtoH", 710, 50, tid=7, corr=3),
    ]
    tr = tracing.parse(events, spans)
    assert tr["window_s"] == pytest.approx(1e-3)
    assert tr["busy_s"] == pytest.approx(390e-6)
    kernels = {o["kernel"]: o for o in tr["ops"]}
    assert kernels["sort_kernel"]["groups"] == {"dispatch"}
    assert kernels["intersect_gather_kernel"]["groups"] == {
        "dispatch", "isect_kernel"}
    assert kernels["Memcpy DtoH"]["groups"] == set()
    bd = tracing.breakdown(tr)
    assert bd["device_ops"][0] == [
        "(anonymous namespace)::intersect_gather_kernel(float const*, int)",
        300e-6]
    assert bd["idle_gaps"][0] == ["ltbench.job", pytest.approx(240e-6)]
    assert bd["idle_gaps"][1] == ["ltbench.job", pytest.approx(160e-6)]
    assert bd["idle_gaps"][2] == ["aten::nonzero", pytest.approx(150e-6)]
    reg = Registry(REPO)
    record = {"frames": 2, "trace": tr,
              "isect_kernels": ["intersect_gather_kernel"],
              "queries": {"nearest": {"queries": 3, "rays": 1000},
                          "any": {"queries": 3, "rays": 500}},
              "num_triangles": 10,
              "peaks": {"hbm_bytes_per_s": 1e9}}

    def read(name):
        return reg.module("metrics", name).read(record)

    assert read("launches_per_frame") == 1.0
    assert read("dispatch_ms_per_frame") == pytest.approx(0.02)
    assert read("isect_kernel_ms_per_frame") == pytest.approx(0.15)
    assert read("device_idle_pct") == pytest.approx(61.0)
    nbytes = 1000 * 36 + 500 * 32 + 6 * 10 * 36
    assert read("isect_roofline_pct") == pytest.approx(
        100 * nbytes / 1e9 / 300e-6)
