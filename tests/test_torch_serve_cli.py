"""PyTorch port, the serve CLI (``python -m repro_torch.launch.serve``),
called in-process with ``--device cpu`` at smoke size: the session and
plan APIs agree, ``--guarded`` equals unguarded, ``--server N`` row j
equals a solo run of request j's prompt, the CNN classifies, and the
audit and integrity flags serve the same tokens and count their checks."""
import _torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest

from repro_torch.launch import serve
from repro_torch.runtime import faults

LM = ["--arch", "qwen3-1.7b", "--mode", "serve_packed", "--device", "cpu",
      "--gen-len", "4"]
CNN = ["--arch", "paper-cnn", "--mode", "serve_packed", "--device", "cpu",
       "--batch", "3"]


@pytest.fixture(autouse=True)
def _no_fault_leaks():
    """The port's fault registry starts clean, and a test that leaks an
    armed fault fails by name."""
    faults.reset()
    yield
    leaked = faults.active_points()
    faults.reset()
    assert not leaked, f"fault(s) still armed at teardown: {leaked}"


@pytest.mark.parametrize("extra", [[], ["--dynamic-a", "--group-size", "8"]])
def test_session_api_equals_plan_api(extra):
    args = LM + ["--batch", "2"] + extra
    a = serve.main(args + ["--api", "session"])
    b = serve.main(args + ["--api", "plan"])
    assert a.shape == (2, 4) and a.dtype == np.int32
    np.testing.assert_array_equal(a, b)


def test_guarded_equals_unguarded(capsys):
    base = serve.main(LM + ["--batch", "2"])
    got = serve.main(LM + ["--batch", "2", "--guarded"])
    np.testing.assert_array_equal(base, got)
    assert "'state': 'healthy'" in capsys.readouterr().out


@pytest.mark.parametrize("extra", [[], ["--guarded", "--step-timeout", "60"]])
def test_server_rows_equal_solo_runs(extra, tmp_path, capsys):
    out = tmp_path / "rows.npy"
    rows = serve.main(LM + ["--server", "3", "--batch", "2",
                            "--prompt-seed", "5", "--prompt-len", "6",
                            "--out-tokens", str(out)] + extra)
    assert rows.shape == (3, 4)
    np.testing.assert_array_equal(np.load(out), rows)
    log = capsys.readouterr().out
    assert "drained=True" in log and "restarts=0" in log
    for j in range(3):
        solo = serve.main(LM + ["--batch", "1", "--prompt-seed", str(5 + j),
                                "--prompt-len", str(6 + j)])
        np.testing.assert_array_equal(rows[j], solo[0], err_msg=f"row {j}")


def test_cnn_classifies_on_both_apis_guarded_or_not():
    a = serve.main(CNN)
    assert a.shape == (3,) and (0 <= a).all() and (a < 10).all()
    np.testing.assert_array_equal(a, serve.main(CNN + ["--api", "plan"]))
    np.testing.assert_array_equal(a, serve.main(CNN + ["--guarded"]))
    np.testing.assert_array_equal(
        serve.main(CNN + ["--dynamic-a"]),
        serve.main(CNN + ["--dynamic-a", "--api", "plan"]))
    with pytest.raises(SystemExit, match="LM decode mode"):
        serve.main(CNN + ["--server", "2"])


@pytest.mark.parametrize("flag", [["--audit-rate", "0.5"],
                                  ["--audit-backend", "torch_ref"],
                                  ["--integrity-every", "4"]])
def test_a9b_flags_raise(flag, capsys):
    """The flags of the second half of the runtime (ROADMAP A.9b) no
    longer raise: each serves, tokens unchanged."""
    rows = serve.main(LM + ["--server", "2"] + flag)
    np.testing.assert_array_equal(rows, serve.main(LM + ["--server", "2"]))
    assert "divergences=0" in capsys.readouterr().out


def test_audit_backend_takes_only_the_plain_versions():
    """An oracle on the serving kernels would audit them against
    themselves: ``--audit-backend`` refuses every name but torch_ref."""
    with pytest.raises(SystemExit):
        serve.main(LM + ["--server", "2", "--audit-backend", "cuda"])


def test_server_audit_and_integrity_flags(capsys):
    """``--audit-rate 1 --integrity-every 2`` in server mode: every request
    audited against ``torch_ref``, the fingerprint checked every 2 steps,
    no divergence, and the same tokens as a run without the flags."""
    args = LM + ["--server", "3", "--batch", "2", "--prompt-seed", "5"]
    plain = serve.main(args)
    capsys.readouterr()
    got = serve.main(args + ["--audit-rate", "1", "--integrity-every", "2"])
    np.testing.assert_array_equal(got, plain)
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if "[serve] server:" in ln][0]
    fields = dict(kv.split("=", 1) for kv in line.split() if "=" in kv)
    assert fields["audits"] == "3" and fields["divergences"] == "0"
    assert fields["quarantines"] == "0"
    assert int(fields["integrity_checks"]) >= 2
    assert fields["state"] == "healthy"


def test_serve_int8_mode_serves(capsys):
    """``--mode serve_int8`` (the reference CLI's default, ``tests/
    test_cli.py::test_serve_cli_int8``): both APIs agree, the server mode's
    row 0 equals a solo run, and at (8, 8) the tokens and the CNN's
    predictions equal ``serve_packed``'s (both routes are exact integer
    products on the same grids)."""
    int8 = [a if a != "serve_packed" else "serve_int8" for a in LM]
    args = int8 + ["--batch", "2", "--prompt-len", "8"]
    a = serve.main(args)
    out = capsys.readouterr().out
    assert "generated" in out and "done" in out
    assert a.shape == (2, 4) and a.dtype == np.int32
    np.testing.assert_array_equal(a, serve.main(args + ["--api", "plan"]))
    np.testing.assert_array_equal(
        a, serve.main(LM + ["--batch", "2", "--prompt-len", "8"]))
    rows = serve.main(int8 + ["--server", "2", "--prompt-len", "8"])
    np.testing.assert_array_equal(rows[0], a[0])
    cnn = [a_ if a_ != "serve_packed" else "serve_int8" for a_ in CNN]
    np.testing.assert_array_equal(serve.main(cnn), serve.main(CNN))


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mixtral-8x7b",
                                  "mamba2-370m", "jamba-v0.1-52b",
                                  "gemma3-12b", "llama3-405b",
                                  "nemotron-4-340b", "musicgen-large"])
def test_other_archs_serve_api_equals_plan_api(arch):
    """Each other smoke LM (the VLM aside: its prefill needs image
    embeddings) serves through both APIs with equal tokens."""
    args = ["--arch", arch, "--device", "cpu", "--batch", "2",
            "--gen-len", "3"]
    a = serve.main(args + ["--api", "session"])
    assert a.shape == (2, 3) and a.dtype == np.int32
    np.testing.assert_array_equal(a, serve.main(args + ["--api", "plan"]))
