"""PyTorch port: the reference's examples as modules of the port
(``repro_torch.examples.{quickstart,precision_profiles,serve_quantized}``)
run on the CPU, their own asserts hold, and the quantities they print that
do not depend on the drawn weights equal the JAX package's (the modeled
speedup, ``==``; the byte laws, ``==``). Without a card, ``device="cuda"``
raises rather than running on the CPU.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import bitpack as jbitpack, cyclemodel as jcm
from repro_torch.examples import precision_profiles, quickstart, serve_quantized

_ROOT = Path(__file__).resolve().parents[1]


def test_quickstart_on_the_cpu(capsys):
    out = quickstart.main(device="cpu")
    printed = capsys.readouterr().out
    assert "quickstart done." in printed
    assert out["speedup"] == jcm.geomean_speedup("lm1b", "t3", "all")
    assert "(paper: 4.38x)" in printed
    # fc0 of the smoke CNN at Pw = 8: the packed bytes and the baseline.
    shape = (2048, 32)
    assert (f"{jbitpack.packed_nbytes(shape, 8)} bytes (8/16 of the "
            f"{jbitpack.baseline_nbytes(shape)}-byte baseline)") in printed
    assert out["rel_err"] < 0.05
    assert out["corr"] > 0.99
    assert set(out["profile"]) == {"conv1", "fc0", "fc1"}
    assert all(2 <= b <= 16 for b in out["profile"].values())


def test_precision_profiles_on_the_cpu(capsys):
    out = precision_profiles.main(device="cpu")
    printed = capsys.readouterr().out
    assert "precision_profiles done." in printed
    assert out["corr"] > 0.97                      # the example's assert
    assert set(out["prof_a"]) == set(out["prof_w"]) == \
        set(precision_profiles.CLASSES)
    assert all(3 <= b <= 16 for b in out["prof_w"].values())
    packed, dense = out["bytes"]
    assert packed < dense
    d = out["dynamic"]
    assert d["static_bits"] == 8
    assert d["plane_fraction_executed"] == pytest.approx(
        d["mean_effective_bits"] / 8, rel=1e-7)


def test_serve_quantized_on_the_cpu(capsys):
    out = serve_quantized.main(device="cpu")
    printed = capsys.readouterr().out
    assert "serve_quantized done." in printed
    assert out["corr_int8"] > 0.99 and out["corr_packed"] > 0.99
    dense, b8, bp = out["bytes"]
    assert bp < dense and b8 < dense
    assert "paper law Pw/16 = 0.50 of bf16" in printed


@pytest.mark.parametrize("example", [quickstart, precision_profiles,
                                     serve_quantized])
def test_examples_refuse_cuda_without_a_card(example):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main()


def test_example_module_runs_from_the_command_line():
    env = {"PYTHONPATH": str(_ROOT / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.serve_quantized",
         "--device", "cpu"], capture_output=True, text=True, env=env,
        cwd=_ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "serve_quantized done." in res.stdout
    assert "jax" not in res.stderr
    np.testing.assert_equal(res.stdout.count("[serve_"), 2)
