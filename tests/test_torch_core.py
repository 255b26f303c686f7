"""PyTorch port, numerics core: quantize, bitpack, weightgroups and policy
held exactly against the JAX package on the same numpy-seeded inputs."""
import _torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitpack as jbitpack
from repro.core import policy as jpolicy
from repro.core import quantize as jq
from repro.core import weightgroups as jwg
from repro_torch.core import bitpack, policy, quantize as q, weightgroups as wg


def _np(a):
    return np.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("bits", [1, 4, 8, 11, 16])
@pytest.mark.parametrize("axis", [None, -1, 0])
def test_quantize_matches_jax(bits, axis):
    x = np.random.default_rng(bits).normal(size=(9, 13)).astype(np.float32) * 3
    jxq, js = jq.quantize(jnp.asarray(x), bits, axis=axis)
    txq, ts = q.quantize(_t(x), bits, axis=axis)
    np.testing.assert_array_equal(txq.numpy(), _np(jxq))
    np.testing.assert_array_equal(ts.numpy(), _np(js))
    assert txq.dtype == torch.int32 and ts.dtype == torch.float32
    assert (q.qmin(bits), q.qmax(bits)) == (jq.qmin(bits), jq.qmax(bits))


def test_quantize_rounds_half_to_even():
    x = np.array([[0.5, 1.5, 2.5, -0.5, -1.5, 127.0]], np.float32)
    scale = np.ones((1, 1), np.float32)
    jxq, _ = jq.quantize(jnp.asarray(x), 8, scale=jnp.asarray(scale))
    txq, _ = q.quantize(_t(x), 8, scale=_t(scale))
    np.testing.assert_array_equal(txq.numpy(), _np(jxq))
    np.testing.assert_array_equal(txq.numpy(), [[0, 2, 2, 0, -2, 127]])


def test_effective_bits_every_int16_magnitude():
    m = np.arange(-32768, 32768, dtype=np.int32).reshape(-1, 1)
    np.testing.assert_array_equal(
        q.effective_bits(_t(m), axis=-1).numpy(),
        _np(jq.effective_bits(jnp.asarray(m), axis=-1)))


@pytest.mark.parametrize("bits", [1, 5, 8, 16])
def test_bit_planes_and_plane_weights(bits):
    rng = np.random.default_rng(bits)
    xq = rng.integers(jq.qmin(bits), jq.qmax(bits) + 1,
                      size=(6, 7)).astype(np.int32)
    planes = q.bit_planes(_t(xq), bits)
    np.testing.assert_array_equal(planes.numpy(),
                                  _np(jq.bit_planes(jnp.asarray(xq), bits)))
    np.testing.assert_array_equal(q.plane_weights(bits).numpy(),
                                  _np(jq.plane_weights(bits)))
    np.testing.assert_array_equal(
        q.to_twos_complement(_t(xq), bits).numpy(),
        _np(jq.to_twos_complement(jnp.asarray(xq), bits)))


@pytest.mark.parametrize("bits", [1, 8, 11, 16])
@pytest.mark.parametrize("k", [27, 32])
@pytest.mark.parametrize("chunk_bytes", [None, 600])
def test_pack_unpack_matches_jax_byte_for_byte(bits, k, chunk_bytes,
                                               monkeypatch):
    if chunk_bytes is not None:   # force several column blocks
        monkeypatch.setattr(bitpack, "_CHUNK_BYTES", chunk_bytes)
    rng = np.random.default_rng(bits * 100 + k)
    wq = rng.integers(jq.qmin(bits), jq.qmax(bits) + 1,
                      size=(k, 20)).astype(np.int32)
    jp = _np(jbitpack.pack_weights(jnp.asarray(wq), bits))
    tp = bitpack.pack_weights(_t(wq), bits)
    assert tp.dtype == torch.uint8 and tuple(tp.shape) == jp.shape
    np.testing.assert_array_equal(tp.numpy(), jp)
    # A tensor packed by JAX unpacks unchanged in the port.
    np.testing.assert_array_equal(bitpack.unpack_weights(_t(jp), bits, k=k).numpy(),
                                  wq)
    assert bitpack.packed_nbytes((k, 20), bits) == \
        jbitpack.packed_nbytes((k, 20), bits) == tp.numel()


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_pack_bits_along_any_axis(axis):
    bits01 = np.random.default_rng(axis + 5).integers(
        0, 2, size=(16, 8, 24)).astype(np.uint8)
    tp = bitpack.pack_bits_along_axis(_t(bits01), axis)
    np.testing.assert_array_equal(
        tp.numpy(), _np(jbitpack.pack_bits_along_axis(jnp.asarray(bits01), axis)))
    np.testing.assert_array_equal(
        bitpack.unpack_bits_along_axis(tp, axis).numpy(), bits01)


def test_pack_bits_rejects_ragged_axis():
    with pytest.raises(ValueError):
        bitpack.pack_bits_along_axis(torch.zeros((5, 3), dtype=torch.uint8), 0)


@pytest.mark.parametrize("n,group", [(32, 16), (40, 16), (10, 4)])
@pytest.mark.parametrize("bits", [4, 8, 11])
def test_weight_group_counts_and_truncation(n, group, bits):
    rng = np.random.default_rng(n + bits)
    wq = rng.integers(jq.qmin(bits), jq.qmax(bits) + 1,
                      size=(24, n)).astype(np.int32)
    wq[:, :group] //= 1 << (bits - 2)   # one narrow group: a count < bits
    counts = wg.weight_group_counts(_t(wq), bits, group)
    jcounts = _np(jwg.weight_group_counts(jnp.asarray(wq), bits, group))
    np.testing.assert_array_equal(counts.numpy(), jcounts)
    assert counts[0] < bits
    low = np.maximum(jcounts - 1, 1)    # truncation below the OR-tree width
    np.testing.assert_array_equal(
        wg.truncate_columns_grouped(_t(wq), low.tolist(), group).numpy(),
        _np(jwg.truncate_columns_grouped(jnp.asarray(wq), low.tolist(), group)))


def test_policy_matches_jax():
    for args in [(8, 8), (4, 11)]:
        assert dataclasses.asdict(policy.uniform_policy(*args)) == \
            dataclasses.asdict(jpolicy.uniform_policy(*args))
    assert dataclasses.asdict(policy.PrecisionPolicy()) == \
        dataclasses.asdict(jpolicy.PrecisionPolicy())
    p = policy.PrecisionPolicy(per_layer={"fc0": policy.LayerPrecision(4, 6)})
    assert p.lookup("fc0") == policy.LayerPrecision(4, 6)
    assert p.lookup("conv1") == policy.LayerPrecision(16, 16)
