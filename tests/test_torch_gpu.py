"""PyTorch port on the card: kernels K1/K2 against their plain versions and
the ``cuda`` session against ``torch_ref``, bit for bit.

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
from repro_torch.kernels.bitserial_conv import (bitserial_conv,
                                                bitserial_conv_plain)
from repro_torch.kernels.bitserial_matmul import (bitserial_matmul,
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


def test_cuda_session_equals_torch_ref(cuda):
    cfg = configs.get("paper_cnn")
    params = cnn.init_params(
        cfg, torch.Generator().manual_seed(0), cuda)
    x = torch.randn((8, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    out = {}
    for be in ("cuda", "torch_ref"):
        sess = repro_torch.compile(cfg, uniform_policy(8, 8),
                                   mode="serve_packed", backend=be,
                                   params=params, device=cuda)
        out[be] = sess.classify(x)
    assert torch.equal(out["cuda"], out["torch_ref"])
