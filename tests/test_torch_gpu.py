"""PyTorch port on the card: kernels K1-K5 against their plain versions and
the ``cuda`` session against ``torch_ref``, bit for bit, on the static,
dynamic (``dynamic_a``) and weight-group paths.

Marked ``gpu``; each test skips without a CUDA device. Run on the card with
``python -m pytest -m gpu tests/test_torch_gpu.py``.
"""
import pytest
import torch

import repro_torch
from repro_torch import configs
from repro_torch.core import bitpack, quantize as q
from repro_torch.core.policy import uniform_policy
from repro_torch.models import cnn
from repro_torch.kernels.bitserial_conv import (
    bitserial_conv, bitserial_conv_dynamic, bitserial_conv_dynamic_plain,
    bitserial_conv_plain, bitserial_conv_wgroup, bitserial_conv_wgroup_plain)
from repro_torch.kernels.bitserial_matmul import (
    bitserial_matmul, bitserial_matmul_dynamic, bitserial_matmul_dynamic_plain,
    bitserial_matmul_plain)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(cuda, x_shape, k, n, w_bits, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(-128, 128, x_shape, generator=g, dtype=torch.int8)
    wq = torch.randint(q.qmin(w_bits), q.qmax(w_bits) + 1, (k, n), generator=g,
                       dtype=torch.int32)
    return x.to(cuda), bitpack.pack_weights(wq, w_bits).to(cuda)


@pytest.mark.parametrize("m,k,n", [(256, 2048, 256), (7, 40, 10)])
@pytest.mark.parametrize("w_bits", [1, 8, 16])
def test_matmul_kernel_equals_plain(cuda, m, k, n, w_bits):
    x, wp = _operands(cuda, (m, k), k, n, w_bits, m + w_bits)
    before = bitserial_matmul.launches
    got = bitserial_matmul(x, wp, w_bits=w_bits)
    torch.cuda.synchronize()
    assert bitserial_matmul.launches == before + 1
    assert torch.equal(got, bitserial_matmul_plain(x, wp, w_bits))


@pytest.mark.parametrize("shape,kernel,stride,rows",
                         [((4, 32, 32, 3), 3, 1, None), ((4, 9, 9, 5), 5, 2, 2),
                          ((4, 8, 8, 64), 1, 1, 3)])
def test_conv_kernel_equals_plain(cuda, shape, kernel, stride, rows):
    x, wp = _operands(cuda, shape, kernel * kernel * shape[3], 40, 11,
                      kernel)
    got = bitserial_conv(x, wp, kernel=kernel, stride=stride, w_bits=11,
                         rows_per_band=rows)
    torch.cuda.synchronize()
    assert torch.equal(got, bitserial_conv_plain(x, wp, kernel=kernel,
                                                 stride=stride, w_bits=11))


def _counts(cuda, shape, bits, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(1, bits + 1, shape, generator=g,
                         dtype=torch.int32).to(cuda)


@pytest.mark.parametrize("m,k,n,w_bits,bn", [(256, 2048, 256, 8, 256),
                                             (9, 40, 40, 11, 16)])
def test_matmul_dynamic_kernel_equals_plain(cuda, m, k, n, w_bits, bn):
    x, wp = _operands(cuda, (m, k), k, n, w_bits, m + w_bits)
    counts = _counts(cuda, (-(-n // bn),), w_bits, n)
    before = bitserial_matmul_dynamic.launches
    got = bitserial_matmul_dynamic(x, wp, counts, w_bits=w_bits, bn=bn)
    torch.cuda.synchronize()
    assert bitserial_matmul_dynamic.launches == before + 1
    assert torch.equal(got, bitserial_matmul_dynamic_plain(x, wp, counts,
                                                           w_bits, bn))


@pytest.mark.parametrize("rows", [None, 3])
def test_conv_wgroup_kernel_equals_plain(cuda, rows):
    x, wp = _operands(cuda, (4, 9, 9, 5), 45, 40, 11, 7)
    counts = _counts(cuda, (3,), 11, 8)
    before = bitserial_conv_wgroup.launches
    got = bitserial_conv_wgroup(x, wp, counts, kernel=3, stride=1, w_bits=11,
                                rows_per_band=rows)
    torch.cuda.synchronize()
    assert bitserial_conv_wgroup.launches == before + 1
    assert torch.equal(got, bitserial_conv_wgroup_plain(
        x, wp, counts, kernel=3, stride=1, w_bits=11))


@pytest.mark.parametrize("shape,kernel,stride,rows,group",
                         [((4, 9, 9, 3), 5, 2, 2, 8),
                          ((4, 16, 16, 8), 3, 1, None, 64)])
def test_conv_dynamic_kernel_equals_plain(cuda, shape, kernel, stride, rows,
                                          group):
    g = torch.Generator().manual_seed(kernel)
    x = torch.randint(-128, 128, shape, generator=g, dtype=torch.int8).to(cuda)
    k8 = -(-kernel * kernel * shape[3] // 8) * 8
    wq = torch.randint(-128, 128, (k8, 24), generator=g,
                       dtype=torch.int8).to(cuda)
    nwin = (-(-shape[1] // stride)) ** 2
    counts = _counts(cuda, (shape[0], -(-nwin // group)), 8, group)
    before = bitserial_conv_dynamic.launches
    got = bitserial_conv_dynamic(x, wq, counts, kernel=kernel, stride=stride,
                                 group_size=group, rows_per_band=rows)
    torch.cuda.synchronize()
    assert bitserial_conv_dynamic.launches == before + 1
    assert torch.equal(got, bitserial_conv_dynamic_plain(
        x, wq, counts, kernel=kernel, stride=stride, group_size=group))


def _skewed_params(cfg, cuda):
    """Random params with every other group of 16 output filters of every
    layer scaled by 1/32: those groups pack to fewer weight planes."""
    params = cnn.init_params(cfg, torch.Generator().manual_seed(0), cuda)
    for p in params.values():
        for g in range(1, -(-p["w"].shape[1] // 16), 2):
            p["w"][:, g * 16:(g + 1) * 16] /= 32
    return params


@pytest.mark.parametrize("path", ["static", "dynamic", "wgroup", "both"])
def test_cuda_session_equals_torch_ref(cuda, path):
    cfg = configs.get("paper_cnn")
    skewed = path in ("wgroup", "both")
    params = (_skewed_params(cfg, cuda) if skewed else
              cnn.init_params(cfg, torch.Generator().manual_seed(0), cuda))
    x = torch.randn((8, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    x[:, 16:] *= 0.02
    policy = uniform_policy(8, 8, dynamic_a=path in ("dynamic", "both"),
                            w_group=16 if skewed else 0)
    out = {}
    for be in ("cuda", "torch_ref"):
        sess = repro_torch.compile(cfg, policy, mode="serve_packed",
                                   backend=be, params=params, device=cuda)
        out[be] = sess.classify(x)
    static = repro_torch.compile(cfg, uniform_policy(8, 8, w_group=0),
                                 mode="serve_packed", params=params,
                                 device=cuda).classify(x)
    assert torch.equal(out["cuda"], out["torch_ref"])
    assert torch.equal(out["cuda"], static)
