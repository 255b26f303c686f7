"""PyTorch port on the card: training on a mesh. One rank over NCCL, a
(1, 1) mesh: smoke qwen3-1.7b's meshed loss and gradients
(``mesh_value_and_grad``) and one ``jit_train_step`` ``torch.equal`` to
the unsharded step's on the card (``dense`` and ``fake_quant``), the
port's kernels launched no time. Marked ``gpu``; skips without a CUDA
device. Run on the card with
``python -m pytest -m gpu tests/test_torch_gpu_dist_train.py``.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import configs, interop
from repro_torch.api.plan import build_plan
from repro_torch.core.policy import uniform_policy
from repro_torch.dist import init_process
from repro_torch.dist.parallel import ShardCtx
from repro_torch.kernels.bitserial_conv import (
    bitserial_conv, bitserial_conv_dynamic, bitserial_conv_wgroup)
from repro_torch.kernels.bitserial_matmul import (bitserial_matmul,
                                                  bitserial_matmul_dynamic)
from repro_torch.kernels.dynamic_quant import dynamic_quant
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import train as T
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import Schedule

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    assert init_process(0, 1, port, "cuda") == "nccl"
    yield make_host_mesh(1, 1, device="cuda")
    dist.destroy_process_group()


def _launches() -> int:
    """K1-K7's launch counts, summed."""
    return sum(k.launches for k in (
        bitserial_matmul, bitserial_conv, bitserial_matmul_dynamic,
        bitserial_conv_wgroup, bitserial_conv_dynamic, dynamic_quant,
        flash_attention))


@pytest.mark.parametrize("mode", ["dense", "fake_quant"])
def test_meshed_step_on_the_card_equals_the_unsharded_one(mesh, mode):
    cfg = configs.get("qwen3-1.7b", smoke=True)
    tc = T.TrainConfig(sched=Schedule(warmup_steps=1, total_steps=10))
    plan = build_plan(cfg, uniform_policy(8, 8), mode)
    whole, specs = T.make_train_state(cfg, tc, device="cuda")
    local, _ = T.make_train_state(cfg, tc, device="cuda", mesh=mesh)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab, (4, 32))
             for k in ("tokens", "labels")}
    before = _launches()
    wl, _, wg = T.value_and_grad(whole["params"], cfg,
                                 T.batch_on(batch, "cuda"), plan)
    gl, _, gg = T.mesh_value_and_grad(local["params"], cfg,
                                      T.batch_on(batch, "cuda"), plan,
                                      ShardCtx(mesh), specs["params"])
    assert torch.isfinite(wl) and torch.equal(wl, gl)
    wg, gg = (interop.flatten_with_paths(t) for t in (wg, gg))
    assert all(torch.equal(wg[k], gg[k]) for k in wg)
    whole, wm = T.make_train_step(cfg, plan, tc)(whole, batch)
    local, gm = T.jit_train_step(cfg, plan, tc, mesh, specs,
                                 T.batch_specs(cfg))(local, batch)
    assert all(torch.equal(wm[k], gm[k]) for k in wm)
    w, g = (interop.flatten_with_paths(t) for t in (whole, local))
    assert all(t.is_cuda for t in g.values())
    assert all(torch.equal(w[k], g[k]) for k in w)
    assert _launches() == before
