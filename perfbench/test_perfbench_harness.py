"""The harness on the CPU: every piece found by name, a new cell and metric
picked up from new files alone, the benchmark file within its contract,
the traffic deterministic under the seed, the metric arithmetic, and
nothing that a run imports named ``jax`` or ``repro``."""
from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import harness, readings, run as run_mod, trace, work
from perfbench.spans import Recorder

HERE = Path(__file__).resolve().parent
BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_pieces_found_by_name(cell):
    c = harness.cell(cell)
    cfg = harness.config(c["config"])
    assert cfg["name"] == c["config"]
    assert hasattr(harness.piece("drivers", c["driver"]), "drive")
    assert hasattr(harness.piece("traffic", c["traffic"]["generator"]),
                   "make")
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert entry["config"] == c["config"] and entry["chips"] == c["chips"]
    assert set(c["limits"]) and all(v >= 0 for v in c["limits"].values())


@pytest.mark.parametrize("metric", [m for m in METRICS if m != "setup_s"])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.piece("metrics", metric).read)


def test_benchmark_file_keeps_its_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [c["name"] for c in BENCH["configs"]] + CELLS + METRICS
    assert all(NAME.match(n) for n in names) and len(set(METRICS)) == len(
        METRICS)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and (
            HERE.parent / c["file"]).is_file()
        assert set(c["reduced"]) == set(harness.load_json(
            HERE.parent / c["file"])["reduced"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for cell in CELLS:
        mine = [m["name"] for m in harness.metrics_of(BENCH, cell, False)]
        assert "setup_s" in mine and len(mine) >= 2
        layer = harness.metrics_of(BENCH, cell, True)
        assert layer
        for m in layer:
            assert m["moves"] in mine
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_new_cell_and_metric_are_found_from_new_files_alone(tmp_path,
                                                            monkeypatch):
    """A cell, a traffic generator and a metric added as files, with
    entries in a copy of BENCHMARK.json, and no file of the harness
    edited."""
    base = tmp_path / "perfbench"
    shutil.copytree(HERE, base, ignore=shutil.ignore_patterns(
        "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    cell = dict(harness.cell("vgg19-packed-b256"))
    cell["traffic"] = dict(cell["traffic"], generator="flat_images")
    (base / "workloads" / "vgg19-flat-b64.json").write_text(json.dumps(cell))
    (base / "traffic" / "flat_images.py").write_text(
        "import torch\n"
        "def make(params, cfg, seed, device):\n"
        "    s = cfg['image_size']\n"
        "    return [torch.full((params['images'], s, s, 3), 0.5)]\n")
    (base / "metrics" / "requests_seen.cnn.py").write_text(
        "def read(run):\n"
        "    return float(len(run.rec.named('session.classify')))\n")
    bench["workloads"].append({"name": "vgg19-flat-b64", "config": "vgg19",
                               "traffic": "vgg19-flat-b64", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "requests_seen.cnn", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "session and model",
                               "moves": "images_per_s",
                               "workloads": ["vgg19-flat-b64"]})
    for m in bench["end_to_end"]:
        if m["name"] == "images_per_s":
            m["workloads"].append("vgg19-flat-b64")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(harness, "HERE", base)
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    got = harness.cell("vgg19-flat-b64")
    assert harness.piece("traffic", got["traffic"]["generator"]).make(
        got["traffic"], {"image_size": 4}, 1, "cpu")[0].shape[1] == 4
    names = [m["name"] for m in harness.metrics_of(harness.benchmark(),
                                                   "vgg19-flat-b64", True)]
    assert "requests_seen.cnn" in names and "mfu.cnn" not in names
    rec = Recorder()
    rec.add("session.classify", 0.0, 1.0, images=64)
    run = harness.Run("vgg19-flat-b64", got, harness.config("vgg19"), 1,
                      1.0, True, torch.device("cpu"), rec=rec)
    assert harness.piece("metrics", "requests_seen.cnn").read(run) == 1.0


@pytest.mark.parametrize("seed", [0, 2**31 + 12345, 2**40 + 1])
def test_image_batches_deterministic_and_stratified(seed, smoke):
    from perfbench.traffic import image_batches as ib
    cfg = smoke["cnn_smoke"]()[0]["sizes"]
    params = {"images": 64, "field": 4, "brightness": [0.02, 1.0],
              "bank": 2}
    a = ib.make(params, cfg, seed, "cpu")
    b = ib.make(params, cfg, seed, "cpu")
    c = ib.make(params, cfg, seed + 1, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (64, cfg["image_size"], cfg["image_size"], 3)
    levels = ib.stratified_log_uniform(64, 0.02, 1.0)
    assert levels.min() > 0.02 and levels.max() < 1.0


@pytest.mark.parametrize("seed", [0, 2**31 + 99, 2**45 + 3])
def test_chat_sessions_deterministic_in_range_same_work(seed):
    from perfbench.traffic import chat_sessions as cs
    for cell in ("dsmoe-chat-c32", "dsmoe-docqa-c8"):
        c = harness.cell(cell)
        p, cfg = c["traffic"], harness.config(c["config"])["sizes"]
        a, b = cs.make(p, cfg, seed), cs.make(p, cfg, seed)
        other = cs.make(p, cfg, seed + 1)
        n = p["block"]
        reqs = [a[i] for i in range(2 * n)]
        assert all(np.array_equal(x[0], b[i][0]) and x[1] == b[i][1]
                   for i, x in enumerate(reqs))
        assert [len(x[0]) for x in reqs] == [len(other[i][0])
                                             for i in range(2 * n)]
        assert [x[1] for x in reqs] == [other[i][1] for i in range(2 * n)]
        assert not np.array_equal(reqs[0][0], other[0][0])
        assert sorted(len(x[0]) for x in reqs[:n]) == sorted(
            len(x[0]) for x in reqs[n:])
        lo, hi = p["prompt_len"]
        for prompt, gen in reqs:
            s = len(prompt)
            assert s <= 512 or s % 512 == 0
            assert lo <= s or s == 512
            assert s <= hi or s % 512 == 0
            assert p["output_len"][0] <= gen <= p["output_len"][1]
            assert s + gen <= c["engine"]["max_seq"]
            assert prompt.min() >= 0 and prompt.max() < cfg["vocab_size"]


def _req(submit, times, prompt=4):
    mod = harness.piece("drivers", "engine")
    return mod.Req(0, np.zeros(prompt, np.int32), len(times), None, submit,
                   admit_t=submit + 0.01, times=list(times))


def test_lm_rates_and_tails_over_all_samples():
    cell = harness.cell("dsmoe-chat-c32")
    rec = Recorder()
    reqs = [_req(10.0 + 0.5 * i, [10.2 + 0.5 * i + 0.1 * j
                                  for j in range(10)]) for i in range(20)]
    reqs.append(_req(9.0, [9.5, 30.0, 31.0]))      # tokens after the window
    rec.counters["requests"] = reqs
    for i in range(20):                 # steps of 0.5 s from 10.0
        rec.add("engine.step", 10.0 + 0.5 * i, 10.5 + 0.5 * i, admitted=0,
                prefill_lens=[], decode_ctx=[])
    rec.spans[-1].start = 19.9          # still running at the window's end
    rec.spans[-1].end = 20.4
    rec.add("engine.step", 20.4, 20.9, admitted=0, prefill_lens=[],
            decode_ctx=[])              # after the window
    run = harness.Run("dsmoe-chat-c32", cell, harness.config(
        cell["config"]), 1, 10.0, False, torch.device("cpu"), rec=rec)
    run.t_start, run.t_end = 10.0, 20.0
    # The window closes at 20.4, where the step running at 20.0 ended.
    n_in = sum(1 for r in reqs for t in r.times if 10.0 <= t <= 20.4)
    assert harness.piece("metrics", "tokens_per_s").read(run) == \
        pytest.approx(n_in / 10.4)
    ttft = [1e3 * (r.times[0] - r.submit_t) for r in reqs
            if 10.0 <= r.submit_t < 20.0]
    assert harness.piece("metrics", "ttft_ms_mean").read(run) == \
        pytest.approx(np.mean(ttft))
    gaps = [1e3 * (b - a) for r in reqs for a, b in zip(r.times, r.times[1:])
            if a >= 10.0 and b <= 20.0]
    assert harness.piece("metrics", "itl_ms_p95").read(run) == \
        pytest.approx(np.percentile(gaps, 95))
    assert harness.piece("metrics", "queue_wait_ms_p50.lm").read(run) == \
        pytest.approx(10.0)


def test_step_medians_and_mfu_read_the_steady_stretch():
    cell = harness.cell("dsmoe-chat-c32")
    cfg = harness.config(cell["config"])
    rec = Recorder()
    rec.add("engine.step", 0.0, 0.5, admitted=1, prefill_lens=[256],
            decode_ctx=[300] * 31)                   # traced
    rec.add("engine.step", 1.0, 1.4, admitted=1, prefill_lens=[128],
            decode_ctx=[100, 200])
    rec.add("engine.step", 1.4, 1.6, admitted=0, prefill_lens=[],
            decode_ctx=[50, 60])
    rec.add("engine.step", 1.6, 1.9, admitted=0, prefill_lens=[],
            decode_ctx=[51, 61])
    run = harness.Run("dsmoe-chat-c32", cell, cfg, 1, 2.0, True,
                      torch.device("cpu"), rec=rec)
    run.t_start, run.t_end, run.traced_until = 0.0, 2.0, 0.9
    assert harness.piece("metrics", "prefill_step_ms_p50.lm").read(run) == \
        pytest.approx(400.0)
    assert harness.piece("metrics", "decode_step_ms_p50.lm").read(run) == \
        pytest.approx(250.0)
    s = cfg["sizes"]
    macs = work.lm_prefill_macs(s, 128) + sum(
        work.lm_macs_per_token(s, c, head=True)
        for c in (100, 200, 50, 60, 51, 61))
    want = 100 * 2 * macs / work.INT8_OPS_PER_S / 0.9
    assert harness.piece("metrics", "mfu.lm").read(run) == pytest.approx(want)


def test_cnn_rate_closes_with_the_request_running_at_the_windows_end():
    cell = harness.cell("vgg19-packed-b256")
    rec = Recorder()
    for i in range(8):                  # requests of 0.3 s from 5.0
        rec.add("session.classify", 5.0 + 0.3 * i, 5.3 + 0.3 * i, req=i,
                images=256 if i != 3 else 0)         # request 3 failed
    run = harness.Run("vgg19-packed-b256", cell, harness.config("vgg19"), 1,
                      2.0, False, torch.device("cpu"), rec=rec)
    run.t_start, run.t_end = 5.0, 7.0
    # Requests 0-6 began in the window; the last ends at 7.1.
    assert harness.piece("metrics", "images_per_s").read(run) == \
        pytest.approx(6 * 256 / 2.1)
    run.traced_until = 5.6
    # Requests 2, 4 and 5 ran after the traced stretch and ended in the
    # window (3 failed, 6 ended after it).
    assert harness.piece("metrics", "classify_ms_mean.cnn").read(run) == \
        pytest.approx(1e3 * (6.8 - 5.6) / 3)
    run.t_start, run.t_end = 9.0, 10.0                # nothing began
    assert harness.piece("metrics", "images_per_s").read(run) is None


def test_model_operations_of_the_configurations():
    cnn = harness.config("vgg19")["sizes"]
    assert 2 * work.cnn_macs_per_image(cnn) == 39_264_124_928
    lm = harness.config("deepseek-moe-16b-l5")["sizes"]
    assert len(work.lm_linears(lm)) == 36
    one = work.lm_macs_per_token(lm, 1, head=False)
    assert work.lm_prefill_macs(lm, 1) == one + 2048 * 102400


def test_idle_share_and_rooflines_from_a_synthetic_trace():
    cell = harness.cell("dsmoe-chat-c32")
    cfg = harness.config(cell["config"])
    rec = Recorder()
    rec.add("engine.step", 0.0, 0.1, admitted=1, prefill_lens=[512],
            decode_ctx=[600] * 32)
    least, calls = readings.k1_least_s(
        harness.Run("x", cell, cfg, 1, 1.0, True, torch.device("cpu")),
        rec.named("engine.step"))
    assert calls == 72
    ops = [("void mm::k1_kernel<C>(...)", i * 100, i * 100 + 50)
           for i in range(calls)]
    ops.append(("elementwise", 10_000, 20_000))
    t = trace.DeviceTrace(ops, [("aten::item", 0, 40_000)], 40e-6)
    assert t.busy_s == pytest.approx((calls * 50 + 10_000) * 1e-9)
    run = harness.Run("dsmoe-chat-c32", cell, cfg, 1, 1.0, True,
                      torch.device("cpu"), rec=rec)
    run.t_start, run.traced_until, run.traced = 0.0, 0.2, t
    rec.counters["k1_launches"] = calls
    assert harness.piece("metrics", "device_idle.lm").read(run) == \
        pytest.approx(100 * (1 - t.busy_s / 40e-6))
    assert harness.piece("metrics", "k1_roofline.lm").read(run) == \
        pytest.approx(100 * least / (calls * 50e-9))
    rec.counters["k1_launches"] = calls - 1           # disagree: no reading
    assert harness.piece("metrics", "k1_roofline.lm").read(run) is None
    assert t.top_ops(1)[0][0] == "elementwise"
    assert t.idle_gaps(1)[0][0] == "aten::item"


def test_percentile_is_numpys():
    v = list(np.random.default_rng(3).random(101))
    for q in (50, 90, 95):
        assert harness.percentile(v, q) == pytest.approx(np.percentile(v, q))
    assert harness.percentile([], 90) is None


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(HERE)) for p in HERE.rglob("*.py")
    if "__pycache__" not in p.parts))
def test_no_jax_or_jax_package_imported(path):
    names = _imports(HERE / path)
    assert not names & {"jax", "jaxlib", "flax", "repro"}
    if path.startswith("reference"):
        assert "repro_torch" not in names


def test_forbidden_modules_compare_whole_names():
    mods = {"repro_torch": 1, "repro_torch.models": 1, "reproduce": 1,
            "torch": 1}
    assert run_mod.forbidden_modules(mods) == []
    mods.update({"repro.core": 1, "jax": 1, "jaxlib.xla": 1})
    assert run_mod.forbidden_modules(mods) == ["jax", "jaxlib.xla",
                                               "repro.core"]


def test_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload",
         "vgg19-packed-b256", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300,
        cwd=HERE.parent)
    assert out.returncode != 0 and "{" not in out.stdout
