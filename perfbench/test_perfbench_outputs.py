"""The output checks on the CPU at the smoke configurations: the port held
against the plain references, the control (the reference at int4 in the
program's place on the timed path) coming out not correct through the
same check, and a whole run of each driver with the timed path broken
underneath coming out not correct."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import harness, weights
from perfbench.reference import cnn as ref_cnn
from perfbench.reference import moe_lm


def _control(run, sess, smoke):
    """A run of the same cell and seed with the control in the program's
    place."""
    ctl = harness.Run(run.cell_name, run.cell, run.config, run.seed,
                      run.seconds, False, run.device)
    driver = harness.piece("drivers", run.cell["driver"])
    return smoke["drive"](ctl, sess, fault=driver.control_fault(ctl, 4))


@pytest.mark.parametrize("cell", ["vgg19-packed-b256", "vgg19-dyn-b256"])
def test_cnn_run_exact_and_control_far(cell, smoke):
    run, sess = smoke["cnn_run"](cell)
    smoke["drive"](run, sess)
    assert run.attempted > 0 and run.failed == 0 and run.correct
    assert run.checks["logit_abs_diff"]["value"] == 0.0
    ctl = _control(run, sess, smoke)
    assert ctl.attempted > 0 and not ctl.correct
    assert ctl.checks["logit_abs_diff"]["value"] > 0.05


def test_cnn_trimming_counts_equal_the_references(smoke):
    """The plane counts the program's trimming route hands its kernels
    (a_planes_share.cnn) equal the reference's own OR-tree counts."""
    run, sess = smoke["cnn_run"]("vgg19-dyn-b256", trace=True)
    run.cell["profile_requests"] = 1
    smoke["drive"](run, sess)
    c = run.rec.counters
    bank = harness.piece("traffic", "image_batches").make(
        run.cell["traffic"], run.config["sizes"], run.seed, "cpu")
    stats = {}
    ref_cnn.forward(weights.cnn_params(run.config["sizes"], run.seed, "cpu"),
                    dict(run.config["sizes"], trim_group=256), bank[0], 8, 8,
                    stats)
    assert (c["a_planes"], c["a_static_planes"]) == (
        stats["planes"], stats["static_planes"])
    assert 0 < c["a_planes"] < c["a_static_planes"]


def test_lm_run_close_and_control_far(smoke):
    run, sess = smoke["lm_run"]()
    smoke["drive"](run, sess)
    assert run.attempted > 0 and run.failed == 0 and run.correct
    gap = run.checks["token_gap"]["value"]
    assert run.rec.counters["checked_tokens"] >= 20
    ctl = _control(run, sess, smoke)
    assert ctl.attempted > 0 and not ctl.correct
    assert ctl.checks["token_gap"]["value"] > 3 * gap


def test_lm_traced_run_counts_the_prefill_drops(smoke):
    """The traced run's capacity-dispatch counters: every admitted
    prompt's expert choices in every MoE layer, and some of them dropped
    (prefill_dropped_share.lm)."""
    run, sess = smoke["lm_run"](trace=True)
    smoke["drive"](run, sess)
    s = run.config["sizes"]
    moe_layers = s["num_hidden_layers"] - s["first_k_dense_replace"]
    lens = [n for st in run.rec.named("engine.step", run.t_start,
                                      run.t_end)
            for n in st.attrs["prefill_lens"]]
    c = run.rec.counters
    assert lens and c["prefill_choices"] == sum(lens) * moe_layers * s[
        "num_experts_per_tok"]
    assert 0 < c["prefill_choices_dropped"] < c["prefill_choices"]
    share = harness.piece("metrics", "prefill_dropped_share.lm").read(run)
    assert share == pytest.approx(100 * c["prefill_choices_dropped"]
                                  / c["prefill_choices"])


def test_lm_reference_prefill_logits_match_the_port(smoke):
    """The reference's last-position logits against the port's prefill on
    the plain route, one prompt: bf16 between layers against float32."""
    import repro_torch
    from repro_torch.core.policy import uniform_policy
    cfg, port = smoke["lm_smoke"]()
    params = weights.lm_params(cfg["sizes"], 5, "cpu")
    sess = repro_torch.compile(port, uniform_policy(8, 8),
                               mode="serve_packed", backend="torch_ref",
                               device="cpu", params=params)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg["sizes"]["vocab_size"], 48))
    got, _ = sess.prefill(tokens[None])
    served = harness.piece("drivers", "engine").served_sizes(cfg)
    want = moe_lm.forward(params, served, tokens, 48, 47, 8, 8)
    err = (got[0, 0].float() - want[0]).abs().max()
    assert err < 0.05 * want.abs().max()


def _fail_cnn_answers(i, images, logits):
    out = logits.clone()
    out[:, 0] += 1.0
    return out


def _fail_cnn_half_batch(i, images, logits):
    out = logits.clone()
    half = out.shape[0] // 2
    out[half:] = out[:half]
    return out


@pytest.mark.parametrize("fault", [_fail_cnn_answers, _fail_cnn_half_batch])
def test_cnn_run_with_a_fault_is_not_correct(fault, smoke):
    run, sess = smoke["cnn_run"]("vgg19-packed-b256")
    smoke["drive"](run, sess, fault=fault)
    assert run.attempted > 0 and not run.correct


def test_lm_run_with_an_altered_token_is_not_correct(smoke):
    """Each decode step's tokens altered where they are produced: the
    argmax of every row moved to another token."""
    run, sess = smoke["lm_run"]()
    decode = sess._decode

    def altered(params, token, pos, cache):
        logits, cache = decode(params, token, pos, cache)
        top = logits.argmax(-1)
        logits = logits.clone()
        logits[torch.arange(logits.shape[0]), (top + 1) % logits.shape[-1]] \
            = logits.max() + 1.0
        return logits, cache

    sess._decode = altered
    smoke["drive"](run, sess)
    assert run.attempted > 0 and not run.correct


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["vgg19-packed-b256", "dsmoe-chat-c32"])
def test_control_fails_at_the_cells_size_on_the_card(cell):
    """On the card at the cell's size: the program's run correct, the run
    with the reference at int4 in its place not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from perfbench import control
    runs = control.readings(cell, 2**31 + 77, 10.0, torch.device("cuda", 0))
    assert runs["program"].correct and runs["program"].failed == 0
    assert runs["control"].attempted > 0 and not runs["control"].correct
