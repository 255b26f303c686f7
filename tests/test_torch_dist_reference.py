"""The port's meshed session against the JAX reference's own meshed session.

The reference runs in a subprocess per model with 8 host devices on a (2, 4)
("data", "model") mesh built with ``Auto`` axes
(``jax.sharding.Mesh(devices.reshape(2, 4), ...)``: ``jax.make_mesh``
builds ``Explicit`` axes on this jax, under which the reference's
sharding constraints refuse its mixed shardings; ROADMAP queue C). The
port runs on a gloo (2, 2) mesh at the same time, on the same weights:
the reference's seed-0 draw, packed, carried across by the reference's
checkpoint and restored with ``shardings=`` straight to each rank's
shards. The
prefill logits, and the logits of every decode step whose inputs agree
(the same greedy tokens before it, and no MoE router near a tie on the
way), must be within ``test_torch_lm``'s 0.2, and the greedy tokens at
those steps equal wherever the reference's top-2 margin exceeds twice
that, as ``test_torch_lm`` holds the unsharded sessions (the two packages
round some float steps differently; the port's meshed logits are
bit-equal to its unsharded ones, test_torch_dist_serve). How many tokens
and decode steps each comparison covers is printed (``pytest -s``) and
held to a floor.

Training: the qwen3 subprocess also trains its seed-0 dense params on
the Auto mesh (its jitted ``value_and_grad`` under the mesh and one
``jit_train_step``), which the port's ranks repeat on the same params
and batch through their own ``jit_train_step``; and it runs
``compressed_psum`` under ``shard_map`` on four devices, against the
port's over its four ranks.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import _dist_ranks as R
from repro import configs as jconfigs

CHECKS = {"qwen3-1.7b": "reference_qwen",
          "deepseek-moe-16b": "reference_deepseek"}
ARCHS = tuple(CHECKS)
BATCH, PROMPT = 8, 16
LOGIT_ATOL = 0.2

_REFERENCE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro import api as loom, configs
from repro.ckpt import checkpoint as ck
from repro.core.policy import uniform_policy
from repro.launch.shapes import _eval_shape_with_specs
from repro.models import model as M
out, gen_len, name = sys.argv[1], int(sys.argv[2]), sys.argv[3]
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 4),
                         ("data", "model"))
cfg = configs.get(name, smoke=True)
# The seed-0 draw and its packing, jitted (the port serves whatever bytes
# they give), saved first: the port's ranks wait for the checkpoint.
structs, specs = _eval_shape_with_specs(
    lambda: M.init_params(jax.random.PRNGKey(0), cfg))
policy = uniform_policy(8, 8)
params = jax.jit(lambda k: M.convert_params_for_serving(
    M.init_params(k, cfg)[0], specs, policy, "serve_packed")[0])(
    jax.random.PRNGKey(0))
specs = M.convert_specs_for_serving(structs, specs, "serve_packed")
ck.save_checkpoint(f"{out}/{name}/ckpt", 0, jax.tree.map(np.asarray, params))
train = name == "qwen3-1.7b"
if train:
    # The seed-0 dense params, for the port's meshed training.
    dense = M.init_params(jax.random.PRNGKey(0), cfg)[0]
    ck.save_checkpoint(f"{out}/{name}/train_ckpt", 0,
                       jax.tree.map(np.asarray, dense))
open(f"{out}/{name}/ready", "w").close()
toks = np.load(f"{out}/{name}/tokens.npy")
# Packed params pass through compile's conversion unchanged.
sess = loom.compile(cfg, policy, mode="serve_packed", params=params,
                    specs=specs, mesh=mesh)
# generate()'s greedy loop, step by step, keeping each step's logits
logits, cache = sess.prefill(toks)
steps = [np.asarray(logits, np.float32)[:, 0]]
for i in range(gen_len - 1):
    tok = np.argmax(steps[-1], axis=-1).astype(np.int32)
    logits, cache = sess.decode(tok, toks.shape[1] + i, cache)
    steps.append(np.asarray(logits, np.float32))
steps = np.stack(steps, axis=1)                        # [B, gen_len, V]
np.savez(f"{out}/{name}/reference.npz", steps=steps,
         tokens=np.argmax(steps, axis=-1).astype(np.int32))
if train:
    # The meshed loss and gradients (jitted under the mesh), then one step
    # of jit_train_step, on the Auto mesh; and compressed_psum under
    # shard_map over four devices.
    from jax.sharding import PartitionSpec as PS
    from repro.api import plan as jplan
    from repro.dist.sharding import resolve_tree
    from repro.launch import train as jtrain
    from repro.optim import Schedule
    from repro.optim.compression import compressed_psum
    batch = {k: jnp.asarray(v) for k, v in
             np.load(f"{out}/{name}/train_batch.npz").items()}
    tc = jtrain.TrainConfig(sched=Schedule(warmup_steps=1, total_steps=10))
    state, sspecs = jtrain.make_train_state(jax.random.PRNGKey(0), cfg, tc)
    tplan = jplan.build_plan(cfg, mode="dense")
    with jax.set_mesh(mesh):
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: M.loss_fn(p, cfg, batch, tplan), has_aux=True),
            in_shardings=(resolve_tree(sspecs["params"], mesh),))(
                state["params"])
        grads = jax.tree.map(lambda g: np.asarray(g, np.float32), grads)
        step = jtrain.jit_train_step(cfg, tplan, tc, mesh, sspecs,
                                     {"tokens": PS("dp", None),
                                      "labels": PS("dp", None)})
        state, metrics = step(state, batch)
    flat = {"/".join(str(k.key) for k in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(grads)[0]}
    new = {"/".join(str(k.key) for k in path): np.asarray(v, np.float32)
           for path, v in jax.tree_util.tree_flatten_with_path(
               state["params"])[0]}
    np.savez(f"{out}/{name}/reference_train.npz", loss=np.asarray(loss),
             step_loss=np.asarray(metrics["loss"]),
             grad_norm=np.asarray(metrics["grad_norm"]),
             lr=np.asarray(metrics["lr"]),
             **{"grad:" + k: v for k, v in flat.items()},
             **{"param:" + k: v for k, v in new.items()})
    pod = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("pod",))
    tree = {k: jnp.asarray(v) for k, v in
            np.load(f"{out}/compress_in.npz").items()}
    tree["b"] = tree["b"].astype(jnp.bfloat16)
    summed = jax.shard_map(
        lambda t: compressed_psum(jax.tree.map(lambda x: x[0], t), "pod"),
        mesh=pod, in_specs=(PS("pod"),), out_specs=PS(),
        check_vma=False)(tree)
    np.savez(f"{out}/compress_ref.npz",
             **{k: np.asarray(v.astype(jnp.float32))
                for k, v in summed.items()})
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the port's ranks, run together; the
    ranks start serving once the subprocess has saved the weights."""
    out = tmp_path_factory.mktemp("reference")
    rng = np.random.default_rng(R.SEED)
    for name in ARCHS:
        vocab = jconfigs.get(name, smoke=True).vocab
        (out / name).mkdir()
        np.save(out / name / "tokens.npy",
                rng.integers(1, vocab, (BATCH, PROMPT)).astype(np.int32))
    vocab = jconfigs.get("qwen3-1.7b", smoke=True).vocab
    np.savez(out / "qwen3-1.7b" / "train_batch.npz",
             **{k: rng.integers(0, vocab, (4, 32)).astype(np.int32)
                for k in ("tokens", "labels")})
    np.savez(out / "compress_in.npz", a=rng.normal(size=(4, 64)).astype(
        np.float32), b=rng.normal(size=(4, 8, 16)).astype(np.float32))
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(
                   [str(root / "src"), os.environ.get("PYTHONPATH", "")]))
    refs = [subprocess.Popen([sys.executable, "-c", _REFERENCE, str(out),
                              str(R.GEN_LEN), name], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for name in ARCHS]
    try:
        results, _ = R.collect(R.start((2, 2), list(CHECKS.values()),
                                       str(out)))
        logs = [p.communicate(timeout=600)[0].decode(errors="replace")
                for p in refs]
    finally:
        for p in refs:
            p.kill()
    for p, log in zip(refs, logs):
        assert p.returncode == 0, log[-4000:]
    return out, results


@pytest.mark.parametrize("name", ARCHS)
def test_port_mesh_ran(runs, name):
    _, results = runs
    got = results[CHECKS[name]]
    assert got == ["ok"] * 4, "\n".join(r for r in got if r != "ok")


def _load(out, name):
    ref = np.load(out / name / "reference.npz")
    ports = [np.load(out / name / f"port_rank{r}.npz") for r in range(4)]
    return ref, ports


def _margins(steps):
    top2 = np.sort(steps, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]                    # [B, gen_len]


# A router gap below this is a near tie between the k-th chosen expert and
# the best one left out, which the reference's jitted meshed session may
# break the other way: its gates round differently from the port's.
ROUTER_TIE = 0.01
# How many (row, step) pairs each comparison covers on this seed, of
# BATCH x GEN_LEN = 48 tokens and BATCH x (GEN_LEN - 1) = 40 decode steps,
# held as floors so that the comparisons cannot silently shrink.
MIN_TOKENS = {"qwen3-1.7b": 11, "deepseek-moe-16b": 9}
MIN_DECODE_STEPS = {"qwen3-1.7b": 27, "deepseek-moe-16b": 14}


def _comparable(p, ref):
    """The (row, step) pairs whose inputs agree in the two packages: the
    greedy tokens before them are equal and no MoE router came to a near
    tie (``ROUTER_TIE``) on the way, where the packages' rounding may send
    a token to another expert and every later step of the row takes other
    inputs."""
    for row in range(BATCH):
        for i in range(R.GEN_LEN):
            if not np.array_equal(p["tokens"][row, :i],
                                  ref["tokens"][row, :i]) \
                    or p["router_gap"][row, i] < ROUTER_TIE:
                break
            yield row, i


@pytest.mark.parametrize("name", ARCHS)
def test_greedy_tokens_equal_reference_mesh(runs, name):
    """Every rank's greedy tokens (the whole batch) equal the reference
    mesh's at each step whose inputs agree and whose reference top-2 logit
    margin exceeds 2 * LOGIT_ATOL (below it the packages' rounding may
    pick the other token: ``test_torch_lm``'s rule); at least
    ``MIN_TOKENS`` of them. ``generate`` gives the step loop's tokens."""
    out, _ = runs
    ref, ports = _load(out, name)
    want = ref["tokens"]
    assert want.shape == (BATCH, R.GEN_LEN)
    margins = _margins(ref["steps"])
    for p in ports:
        assert np.array_equal(p["tokens"], np.argmax(p["steps"], -1))
        compared = 0
        for row, i in _comparable(p, ref):
            if margins[row, i] > 2 * LOGIT_ATOL:
                assert p["tokens"][row, i] == want[row, i], (row, i)
                compared += 1
        print(f"{name}: {compared} of {want.size} greedy tokens compared")
        assert compared >= MIN_TOKENS[name], compared


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_logits_near_reference_mesh(runs, name):
    out, _ = runs
    ref, ports = _load(out, name)
    for p in ports:
        assert p["steps"].shape == ref["steps"].shape
        np.testing.assert_allclose(p["steps"][:, 0], ref["steps"][:, 0],
                                   atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_logits_near_reference_mesh(runs, name):
    """Each row's decode logits within LOGIT_ATOL of the reference mesh's
    at every step whose inputs agree; at least ``MIN_DECODE_STEPS``."""
    out, _ = runs
    ref, ports = _load(out, name)
    for p in ports:
        compared = 0
        for row, i in _comparable(p, ref):
            if i:
                np.testing.assert_allclose(
                    p["steps"][row, i], ref["steps"][row, i],
                    atol=LOGIT_ATOL, rtol=0, err_msg=f"row {row} step {i}")
                compared += 1
        print(f"{name}: {compared} of {BATCH * (R.GEN_LEN - 1)} decode "
              f"steps compared")
        assert compared >= MIN_DECODE_STEPS[name], compared


# Three times the differences measured (relative): the loss 4.20e-4,
# the grad norm 2.69e-4.
TRAIN_LOSS_RTOL, TRAIN_NORM_RTOL = 1.26e-3, 8.1e-4


def _train_leaves(npz, kind: str) -> dict:
    return {k[len(kind) + 1:]: npz[k] for k in npz.files
            if k.startswith(kind + ":")}


def test_meshed_training_near_reference_mesh(runs):
    """qwen3-1.7b's smoke config, seed-0 dense params, trained on the
    port's (2, 2) gloo mesh and on the reference's (2, 4) Auto mesh (its
    jitted ``value_and_grad`` under the mesh, then its ``jit_train_step``):
    the loss within TRAIN_LOSS_RTOL and the grad norm within
    TRAIN_NORM_RTOL relative, every gathered gradient within 5% of the
    leaf's max (``_train_parity``'s bound for the unsharded packages;
    measured: 2.8% at worst), and the params after the step within two
    learning rates plus one bf16 ulp (at most ``|w| * 2**-7``): Adam's
    first step moves a weight by about the learning rate whatever its
    gradient's size, so a gradient near 0 may take either sign, and each
    package rounds the result to bf16."""
    out, _ = runs
    ref = np.load(out / "qwen3-1.7b" / "reference_train.npz")
    port = np.load(out / "qwen3-1.7b" / "port_train.npz")
    for k, rtol in (("loss", TRAIN_LOSS_RTOL), ("step_loss", TRAIN_LOSS_RTOL),
                    ("grad_norm", TRAIN_NORM_RTOL)):
        np.testing.assert_allclose(float(port[k]), float(ref[k]), rtol=rtol)
    assert float(port["lr"]) == float(ref["lr"])
    want, got = _train_leaves(ref, "grad"), _train_leaves(port, "grad")
    assert sorted(want) == sorted(got) and len(want) > 10
    gaps = {k: float(np.abs(got[k] - want[k]).max())
            / max(float(np.abs(want[k]).max()), 1e-30) for k in want}
    print(f"meshed gradients against the reference mesh: worst leaf "
          f"{max(gaps.values())!r} of its max")
    assert max(gaps.values()) <= 0.05, gaps
    lr = float(ref["lr"])
    want, got = _train_leaves(ref, "param"), _train_leaves(port, "param")
    assert sorted(want) == sorted(got)
    for k in want:
        assert (np.abs(got[k] - want[k])
                <= 2 * lr + np.abs(want[k]) * 2.0 ** -7).all(), k


def test_compressed_psum_equals_reference_shard_map(runs):
    """``optim.compressed_psum`` over the port's four gloo ranks against
    the reference's under ``shard_map`` over four devices, each rank's
    leaves a row of one numpy draw: equal (the same four dequantized
    float32 terms summed in the same order; measured equal, so no
    tolerance)."""
    out, _ = runs
    ref = np.load(out / "compress_ref.npz")
    for r in range(4):
        got = np.load(out / f"compress_port{r}.npz")
        assert sorted(got.files) == sorted(ref.files) == ["a", "b"]
        for k in ("a", "b"):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
