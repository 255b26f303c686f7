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
"""
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
import jax, numpy as np
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
