"""PyTorch port, weight fingerprints (``repro_torch.core.integrity``)
against the JAX package's (``repro.core.integrity``).

On the same packed tree the port's per-leaf fingerprint equals the
reference's key for key, as (crc32, shape, dtype name), and the two
``digest()``s are equal: the paper CNN on path W's skewed weights (every
other group of 16 filters scaled by 1/32, so pack-time counts sit below
Pw) and the smoke qwen3 LM. A single ``flip_one_bit`` is caught and
named; drifted or out-of-range plan counts raise ``WeightIntegrityError``
(mirrors ``tests/test_audit.py``'s fingerprint tests).
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import repro.api as loom
from repro.configs import paper_cnn as jpaper_cnn
from repro.configs import qwen3_1_7b as jqwen
from repro.core import integrity as jintegrity
from repro.core.policy import uniform_policy as juniform
from repro.models import cnn as jcnn
from repro.models import model as JM
import repro_torch
from repro_torch import configs, interop
from repro_torch.api import guards
from repro_torch.core import integrity
from repro_torch.core.policy import uniform_policy
from repro_torch.runtime.serving import ServingSupervisor


def _skew(params: dict) -> dict:
    """Path W's weights: every other group of 16 output filters of every
    layer scaled by 1/32 (those groups pack to fewer planes)."""
    out = {}
    for name, p in params.items():
        w = np.array(p["w"], copy=True)
        for g in range(1, -(-w.shape[1] // 16), 2):
            w[:, g * 16:(g + 1) * 16] /= 32
        out[name] = dict(p, w=w)
    return out


@functools.lru_cache(maxsize=None)
def _pair(model: str):
    """(JAX session, port session) compiled for ``serve_packed`` on the
    same JAX seed-0 dense arrays."""
    if model == "cnn":
        jcfg, cfg = jpaper_cnn.smoke_config(), configs.get("paper_cnn",
                                                           smoke=True)
        params, specs = jcnn.init_params(jax.random.PRNGKey(0), jcfg)
        params = _skew(jax.tree.map(np.asarray, params))
    else:
        jcfg, cfg = jqwen.smoke_config(), configs.get("qwen3-1.7b", smoke=True)
        params, specs = JM.init_params(jax.random.PRNGKey(0), jcfg)
        params = jax.tree.map(np.asarray, params)
    jsess = loom.compile(jcfg, juniform(8, 8), mode="serve_packed",
                         backend="xla", params=params, specs=specs)
    tsess = repro_torch.compile(cfg, uniform_policy(8, 8),
                                mode="serve_packed",
                                params=interop.params_from_numpy(params),
                                device="cpu")
    return jsess, tsess


@pytest.mark.parametrize("model", ["cnn", "lm"])
def test_fingerprint_equals_the_reference(model):
    jsess, tsess = _pair(model)
    jf, tf = jsess.fingerprint, tsess.fingerprint
    assert list(sorted(tf.leaves)) == list(sorted(jf.leaves))
    for key, want in jf.leaves.items():
        assert tf.leaves[key] == want, key
    assert tf.group_counts == jf.group_counts
    assert tf.w_bits == jf.w_bits
    assert tf.digest() == jf.digest()
    if model == "cnn":      # path W: pack-time counts below Pw recorded
        assert any(min(c) < 8 for c in tf.group_counts.values())


@pytest.mark.parametrize("model", ["cnn", "lm"])
def test_flip_one_bit_picks_the_reference_leaf_and_is_caught(model):
    jsess, tsess = _pair(model)
    _, jleaf = jintegrity.flip_one_bit(jsess.params)
    n = tsess.verify_integrity("clean")
    assert n == len(tsess.fingerprint.leaves) > 0
    clean = tsess.params
    corrupt, leaf = integrity.flip_one_bit(clean)
    assert leaf == jleaf
    before = interop.flatten_with_paths(clean)[leaf].clone()
    try:
        tsess.params = corrupt
        with pytest.raises(guards.WeightIntegrityError) as ei:
            tsess.verify_integrity("flipped")
        assert leaf in str(ei.value)            # names the exact leaf
        assert isinstance(ei.value, guards.NumericIntegrityError)
        got = interop.flatten_with_paths(corrupt)[leaf]
        diff = (got.reshape(-1).view(torch.uint8)
                ^ before.reshape(-1).view(torch.uint8))
        assert int(diff[0]) == 1 and int(diff[1:].count_nonzero()) == 0
        # the CRC the port reports for the flipped leaf is the
        # reference's for the same bytes
        jcorrupt, _ = jintegrity.flip_one_bit(jsess.params)
        jcrc = jintegrity._leaf_crc(interop.flatten_with_paths(
            jax.tree.map(np.asarray, jcorrupt))[leaf])
        assert integrity._leaf_crc(got) == jcrc
    finally:
        tsess.params = clean
    # the input tree was not touched, and a second flip restores it
    assert torch.equal(interop.flatten_with_paths(clean)[leaf], before)
    again, _ = integrity.flip_one_bit(corrupt, leaf=leaf)
    assert torch.equal(interop.flatten_with_paths(again)[leaf], before)
    assert tsess.verify_integrity("restored") == n


def test_drifted_plan_counts_raise():
    _, sess = _pair("cnn")
    fp = sess.fingerprint
    (name, kind), counts = next(iter(fp.group_counts.items()))
    sess.plan.set_weight_counts(name, kind, [c + 1 for c in counts])
    try:
        with pytest.raises(guards.WeightIntegrityError, match="drifted"):
            sess.verify_integrity("count drift")
    finally:
        sess.plan.set_weight_counts(name, kind, counts)
    assert sess.verify_integrity("counts restored") > 0


@pytest.mark.parametrize("bad", [0, 9])
def test_out_of_range_plan_counts_raise(bad):
    """Counts outside [1, w_bits] are corrupt pass-law metadata even when
    the fingerprint recorded them (mirrors the reference's bound)."""
    _, sess = _pair("cnn")
    fp = sess.fingerprint
    (name, kind), counts = next(iter(fp.group_counts.items()))
    bad_counts = (bad,) + tuple(counts[1:])
    forged = dataclasses.replace(
        fp, group_counts=fp.group_counts | {(name, kind): bad_counts})
    sess.plan.set_weight_counts(name, kind, bad_counts)
    try:
        with pytest.raises(guards.WeightIntegrityError, match="outside"):
            integrity.verify_plan_counts(sess.plan, forged, "forged")
        jforged = jintegrity.WeightFingerprint(
            leaves={}, group_counts=forged.group_counts, w_bits=fp.w_bits)
        with pytest.raises(Exception, match="outside"):
            jintegrity.verify_plan_counts(sess.plan, jforged, "forged")
    finally:
        sess.plan.set_weight_counts(name, kind, counts)


def test_changed_tree_structure_and_dtype_raise():
    _, sess = _pair("lm")
    fp = sess.fingerprint
    params = dict(sess.params)
    del params["final_norm"]
    with pytest.raises(guards.WeightIntegrityError, match="structure"):
        integrity.verify_params(params, fp)
    params = dict(sess.params, final_norm={
        "g": sess.params["final_norm"]["g"].float()})
    with pytest.raises(guards.WeightIntegrityError, match="fingerprinted as"):
        integrity.verify_params(params, fp)


def test_fingerprint_rides_rejit_and_the_supervisor():
    _, sess = _pair("lm")
    assert sess.rejit().fingerprint is sess.fingerprint
    sup = ServingSupervisor(sess)
    assert sup.session.fingerprint is sess.fingerprint
    assert sup.session.verify_integrity() == len(sess.fingerprint.leaves)


def test_dense_sessions_carry_no_fingerprint():
    sess = repro_torch.compile(configs.get("paper_cnn", smoke=True),
                               uniform_policy(8, 8), mode="dense",
                               device="cpu")
    assert sess.fingerprint is None
    assert sess.verify_integrity() == 0


def test_refingerprint_follows_an_intended_swap():
    _, sess = _pair("cnn")
    old, params = sess.fingerprint, sess.params
    try:
        sess.params, _ = integrity.flip_one_bit(params)
        sess.refingerprint()
        assert sess.fingerprint.digest() != old.digest()
        assert sess.verify_integrity() == len(old.leaves)
    finally:
        sess.params, sess.fingerprint = params, old
