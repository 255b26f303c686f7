"""PyTorch port: the paper's reports (``repro_torch.reports``) against the
repo's ``benchmarks/`` scripts, imported read-only with the repo root on
the path (``benchmarks`` has no ``__init__.py``: a namespace package).

Tolerances: none. Rows are equal key for key, floats exactly and NaN
equal to NaN; printed lines are equal character for character once the
port's one MODELED line is dropped. Table 1 from JAX's ``PRNGKey(0)``
params prints the script's lines: the port's forwards run in float64,
the script's in float32, and every decision of this profile clears its
floor by more than 1% of it in float64 (``test_table1_decisions_clear_
their_floor``). The roofline tables and the fleet summary are equal
strings over records of the port's own dry run and hand-built ones.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import contextlib
import glob
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import (fig4 as rfig4, fig5 as rfig5,  # noqa: E402
                        roofline as rroofline, table1 as rtable1,
                        table2 as rtable2, table4 as rtable4)
from repro import configs as jconfigs  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.core import policy  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.reports import (MODELED, fig4, fig5,  # noqa: E402
                                 roofline, table1, table2, table4)
from repro_torch.reports.__main__ import ALL  # noqa: E402

PAIRS = {"table2": (table2, rtable2), "table4": (table4, rtable4),
         "fig4": (fig4, rfig4), "fig5": (fig5, rfig5)}


def _same(a, b) -> bool:
    """Equal values of one type, floats exactly, NaN equal to NaN."""
    if isinstance(a, float) and isinstance(b, float) and a != a:
        return b != b
    return type(a) is type(b) and a == b


def _printed(fn, *args, **kwargs) -> tuple:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return out, buf.getvalue().splitlines()


# -- the cycle model's tables and figures -------------------------------------

@pytest.mark.parametrize("name", ["table2", "table4"])
def test_rows_equal_the_reference(name):
    port, ref = PAIRS[name]
    got, want = port.rows(), ref.rows()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert _same(g[k], w[k]), (g.get("network"), k, g[k], w[k])


def test_table2_keeps_the_nan_rows():
    """nin has no FC layer: its FCL speedups and efficiencies are NaN."""
    nin = [r for r in table2.rows() if r["network"] == "nin"]
    assert len(nin) == 2
    for r in nin:
        assert all(r[f"fcl_{d}_{m}"] != r[f"fcl_{d}_{m}"]
                   for d in table2.DESIGNS for m in ("perf", "eff"))


@pytest.mark.parametrize("name", list(PAIRS))
def test_printed_lines_equal_the_reference(name, capsys):
    port, ref = PAIRS[name]
    ref.main()
    want = capsys.readouterr().out.splitlines()
    port.main()
    got = capsys.readouterr().out.splitlines()
    assert got[0] == MODELED
    assert got[1:] == want


def test_fig5_keeps_the_references_assertion(monkeypatch):
    monkeypatch.setattr(fig5.cm, "scaling_curve",
                        lambda *a: {128: 1.0, 512: 2.0})
    with pytest.raises(AssertionError, match="drops at 512"):
        _printed(fig5.main)


# -- Table 1, live ------------------------------------------------------------

def _jax_operands():
    """JAX's PRNGKey(0) smoke-CNN params as numpy, and the script's images."""
    jcfg = jconfigs.get("paper_cnn", smoke=True)
    params, _ = jcnn.init_params(jax.random.PRNGKey(0), jcfg)
    x = np.random.default_rng(0).normal(
        size=(table1.BATCH, jcfg.img, jcfg.img, 3)).astype(np.float32)
    return jax.tree_util.tree_map(np.asarray, params), x


@pytest.fixture(scope="module")
def jax_table1():
    """(JAX's params, the images, the port's Table 1 rows from them on
    the CPU)."""
    params, x = _jax_operands()
    return params, x, table1.rows(params_from_numpy(params), x,
                                  device="cpu")


def test_table1_from_jax_params_prints_the_reference_lines(jax_table1):
    _, want = _printed(rtable1.main)
    *_, r = jax_table1
    assert table1.lines(r) == want
    assert len(want) == 4 + len(r["layers"])
    assert r["device"] == "cpu"


def test_table1_decisions_clear_their_floor(jax_table1):
    """Every width the search kept or stopped at, on JAX's params: its
    float64 metric lies more than 1% of the floor from the floor (the
    float32 metric moved by 3.2% between the card and the CPU)."""
    params, x, r = jax_table1
    with torch.inference_mode():
        eval_fn = table1.metric(*table1.operands(params, x, "cpu"))
        base = eval_fn(policy.uniform_policy(16, 16))
        floor = base * (1.0 + table1.TOLERANCE)
        assert base < 0
        for what in ("a_bits", "w_bits"):
            for name in r["layers"]:
                for width in {r[what][name], r[what][name] - 1} - {16}:
                    lp = policy.LayerPrecision(
                        a_bits=width if what == "a_bits" else 16,
                        w_bits=width if what == "w_bits" else 16)
                    m = eval_fn(policy.PrecisionPolicy(
                        default=policy.LayerPrecision(16, 16),
                        per_layer={name: lp}))
                    assert (m >= floor) == (width >= r[what][name])
                    assert abs(m - floor) > 0.01 * abs(floor), (
                        name, what, width, m, floor)


def test_table1_on_the_ports_own_draw():
    """No params: torch seed 0 (``cnn.init_params``), the script's
    method; each layer's dynamic statistics at its profiled width."""
    r, lines = _printed(table1.main, device="cpu")
    assert lines == table1.lines(r)
    assert r["layers"] == ["conv1", "fc0", "fc1"]
    for name, d in r["dynamic"].items():
        assert d["static_bits"] == r["a_bits"][name]
        assert 1.0 <= d["mean_effective_bits"] <= d["static_bits"]
        assert d["plane_fraction_executed"] == pytest.approx(
            d["mean_effective_bits"] / d["static_bits"], rel=1e-7)
    assert all(2 <= b <= 16 for p in (r["a_bits"], r["w_bits"])
               for b in p.values())


def test_table1_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        table1.rows(device="cuda")


# -- the roofline report ------------------------------------------------------

@pytest.fixture(scope="module")
def dry_records(tmp_path_factory):
    """One cell traced by the port's dry run, beside hand-built records
    the single-mesh dense table skips: inapplicable, on the multi mesh,
    tagged, of other weights; and one more dense cell."""
    out = tmp_path_factory.mktemp("dryrun_torch")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           "musicgen_large", "--shape", "decode_32k", "--mesh", "single",
           "--out-dir", str(out)]
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH="src"), timeout=300)
    assert r.returncode == 0, (r.stdout[-1500:], r.stderr[-1500:])
    (path,) = glob.glob(str(out / "*.json"))
    with open(path) as f:
        real = json.load(f)
    hand = {
        "qwen3-1.7b__long_500k__single": {
            "arch": "qwen3-1.7b", "shape": "long_500k", "mesh": "single",
            "skipped": "full-attention arch: long_500k inapplicable"},
        "musicgen_large__decode_32k__multi__dense": dict(
            real, mesh="multi", n_devices=512),
        "musicgen_large__decode_32k__single__dense__kv8": dict(
            real, tag="kv8", t_memory_s=real["t_memory_s"] / 2),
        "musicgen_large__decode_32k__single__serve_packed": dict(
            real, weights="serve_packed", exec_mode="serve_packed"),
        "mamba2_370m__long_500k__single__dense": dict(
            real, arch="mamba2_370m", shape="long_500k", t_compute_s=0.25,
            t_memory_s=0.0125, t_collective_s=3.5e-05, dominant="compute",
            ideal_bound_s=0.05, bound_s=0.25, roofline_fraction=0.2,
            useful_flop_ratio=0.875),
    }
    for name, rec in hand.items():
        with open(out / f"{name}.json", "w") as f:
            json.dump(rec, f)
    return out, real


def test_records_dir_is_the_dry_runs():
    assert os.path.normpath(roofline.RESULTS) == \
        os.path.normpath(dryrun.RESULTS_DIR)


def test_roofline_table_equals_the_reference(dry_records):
    out, real = dry_records
    recs = roofline.load(out)
    assert recs == rroofline.load(out) and len(recs) == 6
    for kw in ({}, {"mesh": "multi"}, {"weights": "serve_packed"},
               {"tag": "kv8"}):
        assert roofline.table(recs, **kw) == rroofline.table(recs, **kw)
    lines = roofline.table(recs).splitlines()
    assert len(lines) == 4
    assert lines[-1].startswith("| musicgen_large | decode_32k | "
                                f"{roofline.fmt_ms(real['t_compute_s'])} |")
    assert roofline.fmt_ms(real["t_memory_s"]) == \
        rroofline.fmt_ms(real["t_memory_s"])


def test_fleet_summary_equals_the_reference(dry_records, tmp_path, capsys,
                                            monkeypatch):
    out, real = dry_records
    opt = tmp_path / "opt_torch"
    opt.mkdir()
    opts = [dict(real, tag="kv8", bound_s=real["bound_s"] / 3),
            dict(real, tag="gqa", bound_s=real["bound_s"] / 2),
            dict(real, arch="mamba2_370m", shape="long_500k", tag="kv8",
                 bound_s=0.5),
            dict(real, arch="gemma3_12b", tag="kv8", bound_s=1e-6),
            {"arch": "qwen3-1.7b", "shape": "long_500k", "skipped": "x"}]
    for i, rec in enumerate(opts):
        with open(opt / f"{i}.json", "w") as f:
            json.dump(rec, f)
    recs = roofline.load(out)
    monkeypatch.setattr(rroofline, "load", lambda results_dir=None: (
        recs if results_dir is None else roofline.load(opt)))
    rroofline.main()
    want = capsys.readouterr().out.splitlines()
    got_recs = roofline.main(results_dir=out, opt_dir=opt)
    got = capsys.readouterr().out.splitlines()
    assert got_recs == recs
    assert got[0] == roofline.MODELED
    assert got[1:] == want
    assert want[-1].startswith("-- fleet-optimized (2 cells")
    assert any(ln.startswith("-- multi-pod (512 chips): 1 cells")
               for ln in want)


def test_roofline_without_records_names_the_ports_dry_run(tmp_path, capsys):
    assert roofline.main(results_dir=tmp_path / "none") == []
    assert capsys.readouterr().out.splitlines() == [
        "== roofline: no dry-run results yet "
        "(run python -m repro_torch.launch.dryrun) =="]


# -- the harness --------------------------------------------------------------

def test_harness_runs_table2():
    assert list(ALL) == ["table1", "table2", "table4", "fig4", "fig5",
                         "roofline"]
    r = subprocess.run([sys.executable, "-m", "repro_torch.reports",
                        "table2"], capture_output=True, text=True, cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH="src"), timeout=120)
    assert r.returncode == 0, r.stderr[-1500:]
    lines = r.stdout.splitlines()
    assert lines[1] == "##### table2 " + "#" * 54
    assert lines[2] == MODELED
    assert lines[-1].startswith("##### table2 done in ")
