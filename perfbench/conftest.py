"""The benchmark's CPU tests: the port's smoke configurations, and cells cut
to their size, so a whole run of a driver (set-up, window, output check)
takes about a second here."""
from __future__ import annotations

import dataclasses
import time

import pytest
import torch


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread for each of this folder's tests, and the count as
    it was after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (skips without one); run on the card with "
        "`python -m pytest -m gpu perfbench`")


def cnn_smoke():
    """(configuration file dict, the port's config) of a smoke CNN in
    VGG's form: two 3x3 convs, the second followed by a 2x2 max-pool,
    then two fcs; the port's config built from the file's sizes as the
    driver builds it."""
    from perfbench import harness
    sizes = {"image_size": 16, "in_channels": 3,
             "convs": [{"name": "conv1_1", "filters": 8, "kernel": 3,
                        "stride": 1, "pool": 1},
                       {"name": "conv1_2", "filters": 16, "kernel": 3,
                        "stride": 1, "pool": 2}],
             "fcs": [32, 10]}
    cfg = {"name": "cnn-smoke", "sizes": sizes}
    return cfg, harness.piece("drivers", "classify").port_config(cfg)


def lm_smoke():
    """(configuration file dict, the port's config) of the smoke MoE LM,
    its shared experts the sum of their widths as in the published
    model."""
    from repro_torch.configs import deepseek_moe_16b
    c = deepseek_moe_16b.smoke_config()
    m = dataclasses.replace(c.moe, shared_d_ff=c.moe.n_shared * c.moe.d_ff)
    c = dataclasses.replace(c, moe=m, max_seq=128)
    sizes = {"hidden_size": c.d_model, "num_attention_heads": c.n_heads,
             "num_key_value_heads": c.n_kv_heads, "head_dim": c.d_head,
             "intermediate_size": c.d_ff, "moe_intermediate_size": m.d_ff,
             "n_routed_experts": m.n_experts, "num_experts_per_tok": m.top_k,
             "n_shared_experts": m.n_shared, "first_k_dense_replace": 1,
             "num_hidden_layers": c.n_layers, "vocab_size": c.vocab,
             "rope_theta": c.rope_theta, "rms_norm_eps": 1e-6,
             "norm_topk_prob": False}
    served = {"norm_topk_prob": True, "capacity_factor": m.capacity_factor}
    return {"name": "deepseek-smoke", "sizes": sizes, "served": served}, c


def cnn_run(cell_name: str = "vgg19-packed-b256", seed: int = 2**33 + 7,
            seconds: float = 0.3, trace: bool = False):
    """(Run, session) of a CNN cell at the smoke CNN's size on the CPU."""
    import repro_torch
    from perfbench import harness, weights
    from repro_torch.core.policy import uniform_policy
    cfg, port = cnn_smoke()
    cell = harness.cell(cell_name)
    cell["traffic"].update(images=32, bank=2, field=4)
    cell.update(profile_requests=2, sample=4, warmup=1)
    run = harness.Run(cell_name, cell, cfg, seed, seconds, trace,
                      torch.device("cpu"))
    pol = cell["policy"]
    sess = repro_torch.compile(
        port, uniform_policy(8, 8, dynamic_a=pol["dynamic_a"]),
        mode="serve_packed", device="cpu",
        params=weights.cnn_params(cfg["sizes"], seed, "cpu"))
    return run, sess


def lm_run(cell_name: str = "dsmoe-chat-c32", seed: int = 12345678901,
           seconds: float = 1.0, trace: bool = False):
    """(Run, session) of an LM cell at the smoke MoE LM's size on the CPU:
    4 clients, prompts of 8-64 tokens, outputs of 4-16."""
    import repro_torch
    from perfbench import harness, weights
    from repro_torch.core.policy import uniform_policy
    cfg, port = lm_smoke()
    cell = harness.cell(cell_name)
    cell["engine"] = {"max_batch": 4, "max_seq": 128}
    cell["traffic"].update(block=4, prompt_len=[8, 64], output_len=[4, 16])
    cell.update(clients=4, warmup_steps=2, profile_steps=3,
                sample_tokens=40)
    run = harness.Run(cell_name, cell, cfg, seed, seconds, trace,
                      torch.device("cpu"))
    sess = repro_torch.compile(
        port, uniform_policy(8, 8), mode="serve_packed", device="cpu",
        params=weights.lm_params(cfg["sizes"], seed, "cpu"))
    return run, sess


def drive(run, session, **kw):
    from perfbench import harness, trace
    driver = harness.piece("drivers", run.cell["driver"])
    driver.drive(run, session=session, t_process=time.perf_counter(),
                 profiler=trace.Profiler(run.device), **kw)
    return run


@pytest.fixture
def smoke():
    """The helpers above, for the tests."""
    return dict(cnn_smoke=cnn_smoke, lm_smoke=lm_smoke, cnn_run=cnn_run,
                lm_run=lm_run, drive=drive)
