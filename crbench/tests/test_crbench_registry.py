"""A configuration, a workload and a per-layer metric added as new files
(and entries of BENCHMARK.json) are found by name, with no edit of any
file the benchmark has; and without a CUDA device a run exits non-zero
and prints no result."""

import json
import os
import shutil
import subprocess
import sys

CRBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(CRBENCH)


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(CRBENCH, tmp_path / "crbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    c = tmp_path / "crbench"
    cfg = json.load(open(c / "configs" / "crnerf_gate_render.json"))
    cfg["fields"]["pallas_render"] = False
    json.dump(cfg, open(c / "configs" / "gate_render_perpoint.json", "w"))
    wl = json.load(open(c / "workloads" / "serve_320x240_c4.json"))
    wl["config"] = "gate_render_perpoint"
    json.dump(wl, open(c / "workloads" / "serve_perpoint_c4.json", "w"))
    (c / "metrics" / "serve.frames_seen.py").write_text(
        "def read(d):\n    return float(d['frames'])\n")
    bench["configs"].append({"name": "gate_render_perpoint",
                             "source": "x", "reduced": [], "why": "x",
                             "file": "crbench/configs/"
                                     "gate_render_perpoint.json"})
    bench["workloads"].append({"name": "serve_perpoint_c4",
                               "config": "gate_render_perpoint",
                               "traffic": "serve_closed_c4", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "serve.frames_seen",
                               "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "x",
                               "moves": "serve_frames_per_s",
                               "workloads": ["serve_perpoint_c4"]})
    for m in bench["end_to_end"]:
        if "serve_320x240_c4" in m.get("workloads", []):
            m["workloads"].append("serve_perpoint_c4")
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))
    code = (
        "import json\n"
        "from crbench import run\n"
        "from crbench.harness import load_json\n"
        "b = run.benchmark()\n"
        "w = load_json('workloads', 'serve_perpoint_c4.json')\n"
        "c = load_json('configs', w['config'] + '.json')\n"
        "e2e = [m['name'] for m in run.metrics_for(b, 'serve_perpoint_c4', "
        "False)]\n"
        "layer = [m['name'] for m in run.metrics_for(b, 'serve_perpoint_c4',"
        " True)]\n"
        "print(json.dumps([run.cell_of(b, 'serve_perpoint_c4')['chips'], "
        "c['fields']['pallas_render'], e2e, layer, "
        "run.reader('serve.frames_seen')({'frames': 3})]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    chips, perpoint, e2e, layer, seen = json.loads(out.stdout)
    assert (chips, perpoint, seen) == (1, False, 3.0)
    assert set(e2e) == {"setup_s", "serve_frames_per_s", "serve_p95_ms"}
    assert layer == ["serve.frames_seen"]


def test_every_listed_metric_has_its_reader():
    sys.path.insert(0, REPO)
    from crbench import run

    bench = run.benchmark()
    for m in bench["per_layer"]:
        assert callable(run.reader(m["name"]))
    for w in bench["workloads"]:
        wl = json.load(open(os.path.join(CRBENCH, "workloads",
                                         w["name"] + ".json")))
        assert wl["config"] == w["config"]
        assert os.path.exists(os.path.join(CRBENCH, "traffic",
                                           wl["kind"] + ".py"))
        assert run.metrics_for(bench, w["name"], True)


def test_without_a_card_a_run_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "crbench.run", "--workload",
         "train_stash_g1", "--seed", "2147483659", "--seconds", "1",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr
