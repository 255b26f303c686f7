"""The reference's two training examples on the port, on the CPU:
``repro_torch.examples.train_lm`` (its small model, a short run whose
loss must fall) and ``repro_torch.examples.fault_tolerance`` (the resumed
run ``torch.equal`` to the uninterrupted one, every leaf of the state,
and the elastic restore onto another mesh layout), in this process (a
world of one rank) and ``fault_tolerance`` also as two gloo ranks started
from the command line, as ``torchrun`` would start them."""
import _torch_threads  # noqa: F401  (first: one torch thread)
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.examples import fault_tolerance, train_lm

_ROOT = Path(__file__).resolve().parents[1]


def test_train_lm_on_the_cpu(tmp_path, capsys):
    out = train_lm.main(device="cpu", steps=24, batch=8, seq=32, small=True,
                        ckpt_dir=str(tmp_path))
    printed = capsys.readouterr().out
    assert len(out["losses"]) == 24 and out["restarts"] == 0
    assert "lm-10m: 5.2M params, 1 rank(s)" in printed
    assert "train_lm done." in printed


def test_fault_tolerance_on_the_cpu(capsys):
    out = fault_tolerance.main(device="cpu")
    assert out == {"restarts": 1, "leaves": 37, "world": 1}
    assert "fault_tolerance done." in capsys.readouterr().out


def test_fault_tolerance_on_two_ranks_from_the_command_line():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(PYTHONPATH=str(_ROOT / "src"), PATH="/usr/bin:/bin",
               OMP_NUM_THREADS="1", WORLD_SIZE="2", MASTER_PORT=str(port))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.examples.fault_tolerance",
         "--device", "cpu"], env=dict(env, RANK=str(r)), cwd=_ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    assert "elastic restore from a (2, 1) mesh onto (1, 2): OK" in outs[0][0]
    assert "fault_tolerance done." in outs[0][0]
    assert outs[1][0] == ""                  # rank 1 prints nothing


@pytest.mark.parametrize("example", [train_lm, fault_tolerance])
def test_training_examples_refuse_cuda_without_a_card(example):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main()
