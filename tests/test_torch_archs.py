"""PyTorch port, the MoE, SSM and hybrid architectures at their smoke
configs on the CPU, against the JAX package: deepseek-moe-16b and
mixtral-8x7b (MoE), mamba2-370m (SSM) and jamba-v0.1-52b (hybrid). The
dense variants (gemma3-12b, llama3-405b, nemotron-4-340b, musicgen-large
and llama-3.2-vision-90b) are in ``test_torch_archs_dense.py``, to keep
each file near a minute on one worker.

Same params (JAX ``init_params`` -> numpy -> ``interop.params_from_numpy``)
and the same token ids. Each arch runs in the three modes (``dense``,
``serve_int8``, ``serve_packed``) a prefill of 2 x 16 tokens and 3
greedy decode steps against the un-jitted JAX ``model.prefill`` /
``model.decode_step`` (``_archs_parity.py``: logits within 0.2, tokens
where the margin is clear). The configs of all nine, and the param and
cache trees, equal JAX's; ``serve_int8`` equals ``serve_packed`` bit for
bit; the batching engine gives every batched row its solo run's bits on
the MoE and the SSM.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.api as loom
from repro.configs import get as jget
from repro.core.policy import uniform_policy as juniform_policy
import repro_torch
from repro_torch import configs, interop
from repro_torch.core.policy import uniform_policy
from repro_torch.models import model as M
from repro_torch.runtime.batching import BatchingEngine

from _archs_parity import MODES, arch_case, check_int8_equals_packed, \
    check_prefill_and_decode, check_trees

ARCHS = ("deepseek-moe-16b", "mixtral-8x7b", "mamba2-370m",
         "jamba-v0.1-52b")
ALL_ARCHS = ARCHS + ("gemma3-12b", "llama3-405b", "nemotron-4-340b",
                     "musicgen-large", "llama-3.2-vision-90b")


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return arch_case(request.param)


def test_configs_match_jax_field_by_field():
    for name in ALL_ARCHS:
        for smoke in (False, True):
            t, j = configs.get(name, smoke), jget(name, smoke)
            names = {f.name for f in dataclasses.fields(t)}
            assert names == {f.name for f in dataclasses.fields(j)}
            for f in sorted(names - {"pattern", "moe", "ssm"}):
                assert getattr(t, f) == getattr(j, f), (name, smoke, f)
            assert [dataclasses.asdict(s) for s in t.pattern] == \
                [dataclasses.asdict(s) for s in j.pattern], (name, smoke)
            for sub in ("moe", "ssm"):
                ts, js = getattr(t, sub), getattr(j, sub)
                assert (ts is None) == (js is None), (name, sub)
                for f in dataclasses.fields(ts) if ts else ():
                    assert getattr(ts, f.name) == getattr(js, f.name)
    assert configs.get("deepseek_moe_16b") == configs.get("deepseek-moe-16b")


def test_param_and_cache_trees_match_jax(arch):
    check_trees(arch)


@pytest.mark.parametrize("mode", MODES)
def test_prefill_and_decode_match_jax(arch, mode):
    check_prefill_and_decode(arch, mode)


def test_serve_int8_equals_serve_packed(arch):
    check_int8_equals_packed(arch)


@pytest.mark.parametrize("mode", ["serve_int8", "serve_packed"])
def test_converted_tree_and_fingerprint_match_jax(arch, mode):
    """The serving conversion of the whole tree (experts per expert, the
    shared experts, the SSM's projections; the router and the conv left
    dense) equals JAX's leaf for leaf, byte for byte;
    ``interop.params_from_numpy`` carries JAX's converted tree (3-D and
    packed experts, the float32 router, ``A_log``, the conv) unchanged;
    and the compiled sessions' weight fingerprints have equal digests."""
    jsess = loom.compile(arch["jcfg"], juniform_policy(8, 8), mode=mode,
                         backend="xla", params=arch["params"],
                         specs=arch["specs"])
    want = interop.flatten_with_paths(jax.tree.map(np.asarray,
                                                   jsess.params))
    carried = interop.params_from_numpy(jax.tree.map(np.asarray,
                                                     jsess.params))
    got = M.convert_params_for_serving(arch["tparams"], uniform_policy(8, 8),
                                       mode)
    for tree in (got, carried):
        flat = interop.flatten_with_paths(tree)
        assert sorted(flat) == sorted(want)
        for key, leaf in flat.items():
            np.testing.assert_array_equal(
                interop.host_array(leaf),
                want[key].view(interop.EXT_STORAGE.get(want[key].dtype.name,
                                                       want[key].dtype)),
                err_msg=key)
    tsess = repro_torch.compile(arch["cfg"], uniform_policy(8, 8), mode=mode,
                                params=arch["tparams"], device="cpu")
    assert tsess.fingerprint.digest() == jsess.fingerprint.digest()


@pytest.mark.parametrize("name,lengths", [("deepseek-moe-16b", (5, 9, 13)),
                                          ("mamba2-370m", (16, 32, 48))])
def test_engine_batched_rows_equal_solo(name, lengths):
    """Three requests into 4 slots, submitted together: every stream and
    every batched decode row's logits equal the request's solo run (the
    MoE's per-row dispatch, the SSM's conv history and state in the
    pool)."""
    cfg = configs.get(name, smoke=True)
    sess = repro_torch.compile(cfg, uniform_policy(8, 8),
                               mode="serve_packed", device="cpu")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg.vocab, size=n).astype(np.int32)
               for n in lengths]
    gen, max_seq = 5, 64
    solo_rows = []
    for p_ in prompts:
        logits, cache = sess.prefill(p_[None, :], sess.init_cache(1, max_seq))
        rows, tok = [], torch.argmax(logits[:, 0], dim=-1)
        for i in range(gen - 1):
            logits, cache = sess.decode(tok, len(p_) + i, cache)
            rows.append(logits[0])
            tok = torch.argmax(logits, dim=-1)
        solo_rows.append(rows)
    seen, ref = [], []
    decode = sess._decode

    def recorded(params, token, pos, cache):
        logits, cache = decode(params, token, pos, cache)
        for slot, req in ref[0].active.items():
            seen.append((req.request_id, req.n_generated, logits[slot]))
        return logits, cache
    eng = BatchingEngine(dataclasses.replace(sess, _decode=recorded),
                         max_batch=4, max_seq=max_seq)
    ref.append(eng)
    handles = [eng.submit(p_, gen) for p_ in prompts]
    eng.run(max_steps=50)
    for p_, h in zip(prompts, handles):
        np.testing.assert_array_equal(
            h.result(timeout=30.0),
            sess.generate(p_[None, :], gen, max_seq=max_seq)[0])
    assert len(seen) == len(prompts) * (gen - 1)
    for rid, idx, row in seen:
        assert torch.equal(row, solo_rows[rid][idx - 1]), (rid, idx)
