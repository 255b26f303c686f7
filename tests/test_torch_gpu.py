"""PyTorch port on the card: kernels K1-K6 against their plain versions bit
for bit (K1 and K3 on both of their tensor-core routes; K3, K4 and K5 with
random, full and all-1 plane counts) and K7 within its tolerance
(on both of its routes); the ``cuda`` CNN session against
``torch_ref``, bit for bit, on the static, dynamic (``dynamic_a``) and
weight-group paths, and the smoke LM's prefill and decode likewise; the
batching engine's streams and batched decode logits against solo runs,
guarded and supervised, with the watchdog and through a restart; a
kernel that fails on the card raising, never replaced by its plain
version; the weight fingerprint on the card equal to the CPU's; and a
shadow audit on the card whose quarantine demotes nothing; RMSNorm's
rows equal to rows normalised alone; ``attn_int8``'s integer product
equal to the CPU's and the exact one up to 32768 long; each decode
route's row equal to the row attended alone; and the MoE's router,
expert products and block, and the SSM's decode step, each row equal to
the row run alone; training: the smoke LM's loss and gradients (dense
and ``fake_quant``) on the card against the CPU, the flash VJP against
autograd, and an AdamW step against the CPU's; a smoke train step under
the op analyzer equal to its dry run, its backward counted; a
world-size-1 mesh on NCCL equal to the unmeshed session.

Marked ``gpu``; each test skips without a CUDA device. Run on the card with
``python -m pytest -m gpu tests/test_torch_gpu.py``.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import pytest
import torch

import repro_torch
from repro_torch import configs
from repro_torch.core import bitpack, quantize as q
from repro_torch.core.policy import uniform_policy
from repro_torch.models import cnn
from repro_torch.kernels.bitserial_conv import (
    bitserial_conv, bitserial_conv_dynamic, bitserial_conv_dynamic_plain,
    bitserial_conv_plain, bitserial_conv_wgroup, bitserial_conv_wgroup_plain,
    conv_tc_layout, conv_tc_layout_bytes)
from repro_torch.kernels.bitserial_matmul import (
    bitserial_matmul, bitserial_matmul_dynamic, bitserial_matmul_dynamic_plain,
    bitserial_matmul_plain)
from repro_torch.kernels.dynamic_quant import dynamic_quant, dynamic_quant_plain
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)

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


# The CNN's fc0 and a ragged shape; then K1 on both sides of its skinny/tile
# boundary at the LM's shapes, and the LM head at decode.
_K1_CASES = ([(m, k, n, w) for m, k, n in [(256, 2048, 256), (7, 40, 10)]
              for w in (1, 8, 16)]
             + [(m, k, n, w) for m in (1, 2, 15, 16, 17, 64, 256, 1024)
                for k, n, w in [(2048, 1024, 1), (2048, 1024, 4),
                                (2048, 1024, 8), (2048, 1024, 11),
                                (2048, 1024, 16), (2048, 2048, 8),
                                (2048, 6144, 8), (6144, 2048, 8)]]
             + [(2, 2048, 151936, 8)])


@pytest.mark.parametrize("m,k,n,w_bits", _K1_CASES)
def test_matmul_kernel_equals_plain(cuda, m, k, n, w_bits):
    x, wp = _operands(cuda, (m, k), k, n, w_bits, m + w_bits)
    before = bitserial_matmul.launches
    got = bitserial_matmul(x, wp, w_bits=w_bits)
    torch.cuda.synchronize()
    assert bitserial_matmul.launches == before + 1
    assert torch.equal(got, bitserial_matmul_plain(x, wp, w_bits))


@pytest.mark.parametrize("m", [2, 1024])
def test_matmul_kernel_wraps_like_int32(cuda, m):
    """An operand pair whose int32 sum wraps: the kernel wraps as the
    reference's int32 accumulator does (no saturation), split K or not."""
    x = torch.full((m, 6144), -128, dtype=torch.int8)
    x[0, ::3] = 127
    wq = torch.full((6144, 16), -2 ** 15, dtype=torch.int32)
    wq[:, 1] = 2 ** 15 - 1
    x, wp = x.to(cuda), bitpack.pack_weights(wq, 16).to(cuda)
    want = bitserial_matmul_plain(x, wp, 16)
    assert (x.double() @ wq.to(cuda).double() != want.double()).any()
    got = bitserial_matmul(x, wp, w_bits=16)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# K2 and K5 also at an odd batch on a one-tile band (blocks of two images,
# the last one short), C = 512 (K = 4608, reduced in chunks) and N = 10
# (int32 rows not a multiple of 16 bytes).
_ODD_CHUNKED_RAGGED = [((3, 8, 8, 64), 3, 1, None, 128),
                       ((2, 6, 6, 512), 3, 1, None, 40),
                       ((4, 9, 9, 5), 3, 1, 3, 10)]


@pytest.mark.parametrize("shape,kernel,stride,rows,n",
                         [((4, 32, 32, 3), 3, 1, None, 40),
                          ((4, 9, 9, 5), 5, 2, 2, 40),
                          ((4, 8, 8, 64), 1, 1, 3, 40)] + _ODD_CHUNKED_RAGGED)
def test_conv_kernel_equals_plain(cuda, shape, kernel, stride, rows, n):
    x, wp = _operands(cuda, shape, kernel * kernel * shape[3], n, 11,
                      kernel)
    before = bitserial_conv.launches
    got = bitserial_conv(x, wp, kernel=kernel, stride=stride, w_bits=11,
                         rows_per_band=rows)
    torch.cuda.synchronize()
    assert bitserial_conv.launches == before + 1
    assert torch.equal(got, bitserial_conv_plain(x, wp, kernel=kernel,
                                                 stride=stride, w_bits=11))


@pytest.mark.parametrize("w,c,kernel,stride,rpb,kc,wide", [
    (32, 3, 3, 1, 32, 32, False), (16, 32, 3, 1, 16, 288, True),
    (8, 64, 3, 1, 8, 576, False), (9, 5, 5, 2, 3, 128, True),
    (6, 512, 3, 1, 6, 1152, False)])
def test_conv_tc_layout_equals_kernel(cuda, w, c, kernel, stride, rpb, kc,
                                      wide):
    """The Python mirror of the block's shared memory equals the built
    kernel's own sum (``tcconv::Layout``), the count tables included."""
    assert conv_tc_layout(w, c, kernel=kernel, stride=stride, rpb=rpb, kc=kc,
                          wide=wide)["bytes"] == conv_tc_layout_bytes(
        w, c, kernel=kernel, stride=stride, rpb=rpb, kc=kc, wide=wide)


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


def _count_kinds(cuda, shape, bits, seed):
    """Random counts in [1, bits], every count full, every count 1."""
    return [_counts(cuda, shape, bits, seed),
            torch.full(shape, bits, dtype=torch.int32, device=cuda),
            torch.ones(shape, dtype=torch.int32, device=cuda)]


# K3 on both tensor-core routes (M 10: skinny, 1024: tile) at column groups
# of 12 (not a multiple of 8), 16 and 256, ragged K and N.
@pytest.mark.parametrize("m", [10, 1024])
@pytest.mark.parametrize("bn", [12, 16, 256])
@pytest.mark.parametrize("w_bits", [8, 11, 16])
def test_matmul_dynamic_kernel_count_edges(cuda, m, bn, w_bits):
    k, n = 2040, 520
    x, wp = _operands(cuda, (m, k), k, n, w_bits, m + bn + w_bits)
    for counts in _count_kinds(cuda, (-(-n // bn),), w_bits, bn + w_bits):
        got = bitserial_matmul_dynamic(x, wp, counts, w_bits=w_bits, bn=bn)
        torch.cuda.synchronize()
        assert torch.equal(got, bitserial_matmul_dynamic_plain(
            x, wp, counts, w_bits, bn))


@pytest.mark.parametrize("m", [2, 1024])
def test_matmul_dynamic_kernel_wraps_like_int32(cuda, m):
    """K1's wrapping operands through K3 at full counts."""
    x = torch.full((m, 6144), -128, dtype=torch.int8)
    x[0, ::3] = 127
    wq = torch.full((6144, 16), -2 ** 15, dtype=torch.int32)
    wq[:, 1] = 2 ** 15 - 1
    x, wp = x.to(cuda), bitpack.pack_weights(wq, 16).to(cuda)
    full = torch.full((1,), 16, dtype=torch.int32, device=cuda)
    got = bitserial_matmul_dynamic(x, wp, full, w_bits=16, bn=16)
    torch.cuda.synchronize()
    assert torch.equal(got, bitserial_matmul_plain(x, wp, 16))


# K4 at the paper CNN's convs (B 2 and 256), a ragged last filter group
# (N 40; N 10, whose int32 rows are not a multiple of 16 bytes), stride 2,
# k 1 and 5, and C = 512 (K = 4608, reduced in chunks).
_K4_SHAPES = [(256, 32, 3, 32, 3, 1), (256, 16, 32, 64, 3, 1),
              (256, 8, 64, 128, 3, 1), (2, 32, 3, 32, 3, 1),
              (2, 16, 32, 64, 3, 1), (2, 8, 64, 128, 3, 1),
              (8, 9, 5, 40, 3, 1), (8, 9, 5, 10, 3, 1), (8, 9, 5, 40, 3, 2),
              (8, 9, 5, 40, 5, 2), (8, 9, 8, 16, 1, 1), (2, 6, 512, 40, 3, 1)]


@pytest.mark.parametrize("b,h,c,n,kernel,stride", _K4_SHAPES)
@pytest.mark.parametrize("w_bits", [8, 11, 16])
@pytest.mark.parametrize("w_group", [16, 12])
def test_conv_wgroup_kernel_count_edges(cuda, b, h, c, n, kernel, stride,
                                        w_bits, w_group):
    x, wp = _operands(cuda, (b, h, h, c), kernel * kernel * c, n, w_bits,
                      b + h + c + w_bits)
    for counts in _count_kinds(cuda, (-(-n // w_group),), w_bits,
                               n + w_group):
        want = bitserial_conv_wgroup_plain(x, wp, counts, kernel=kernel,
                                           stride=stride, w_bits=w_bits,
                                           w_group=w_group)
        for rows in (None, 3):
            got = bitserial_conv_wgroup(x, wp, counts, kernel=kernel,
                                        stride=stride, w_bits=w_bits,
                                        w_group=w_group, rows_per_band=rows)
            torch.cuda.synchronize()
            assert torch.equal(got, want)


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


@pytest.mark.parametrize("shape,kernel,stride,rows,n", [
    ((4, 9, 9, 3), 5, 2, 2, 24), ((4, 16, 16, 8), 3, 1, None, 24)]
    + _ODD_CHUNKED_RAGGED)
@pytest.mark.parametrize("group", [8, 64])
def test_conv_dynamic_kernel_equals_plain(cuda, shape, kernel, stride, rows,
                                          n, group):
    g = torch.Generator().manual_seed(kernel)
    x = torch.randint(-128, 128, shape, generator=g, dtype=torch.int8).to(cuda)
    k8 = -(-kernel * kernel * shape[3] // 8) * 8
    wq = torch.randint(-128, 128, (k8, n), generator=g,
                       dtype=torch.int8).to(cuda)
    nwin = (-(-shape[1] // stride)) ** 2
    for counts in _count_kinds(cuda, (shape[0], -(-nwin // group)), 8, group):
        before = bitserial_conv_dynamic.launches
        got = bitserial_conv_dynamic(x, wq, counts, kernel=kernel,
                                     stride=stride, group_size=group,
                                     rows_per_band=rows)
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


def test_cuda_session_both_paths_at_serving_batch(cuda):
    """Path D on the skewed weights (K5 on the convs, K3 on the FCs) at the
    serving batch of 256: ``cuda`` == ``torch_ref`` == the untrimmed
    static logits."""
    cfg = configs.get("paper_cnn")
    params = _skewed_params(cfg, cuda)
    x = torch.randn((256, 32, 32, 3),
                    generator=torch.Generator().manual_seed(2))
    x[:, 16:] *= 0.02
    out = {be: repro_torch.compile(cfg, uniform_policy(8, 8, dynamic_a=True),
                                   mode="serve_packed", backend=be,
                                   params=params, device=cuda).classify(x)
           for be in ("cuda", "torch_ref")}
    static = repro_torch.compile(cfg, uniform_policy(8, 8, w_group=0),
                                 mode="serve_packed", params=params,
                                 device=cuda).classify(x)
    assert torch.equal(out["cuda"], out["torch_ref"])
    assert torch.equal(out["cuda"], static)


def _flush_cases() -> torch.Tensor:
    """[4, 1024]: group 0 of each row is one that subnormal flushing
    decides (all zeros; +-2e-38; a subnormal among zeros; 1e-36 among
    zeros and subnormals)."""
    x = torch.randn((4, 1024), generator=torch.Generator().manual_seed(7))
    x[:, :256] = 0.0
    x[1, :256] = 2e-38
    x[2, 3] = 1e-39
    x[3, 3], x[3, 4], x[3, 9] = 1e-36, 1e-38, -3e-39
    return x


@pytest.mark.parametrize("m,k,g", [(1024, 2048, 256), (1000, 512, 128),
                                   (3, 1024, 512), (4, 1024, 256)])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_dynamic_quant_kernel_equals_plain(cuda, m, k, g, bits):
    gen = torch.Generator().manual_seed(m + k)
    x = torch.randn((m, k), generator=gen) * 10.0 ** (
        torch.rand((m, 1), generator=gen) * 6 - 3)
    if m == 4:
        x = _flush_cases()
    x = x.to(cuda)
    before = dynamic_quant.launches
    got = dynamic_quant(x, group_size=g, bits=bits)
    torch.cuda.synchronize()
    assert dynamic_quant.launches == before + 1
    for a, b in zip(got, dynamic_quant_plain(x, g, bits)):
        assert torch.equal(a, b)


# Shapes of both routes (tensor cores for bf16, CUDA cores for f32), then
# both across head dims, lengths and masks.
_K7_CASES = [((1, 4, 1024, 128), torch.bfloat16, True, None),
             ((1, 4, 1024, 128), torch.bfloat16, True, 100),
             ((2, 2, 300, 64), torch.float32, False, None),
             ((1, 2, 100, 256), torch.float32, True, 17),
             ((1, 1, 33, 16), torch.float32, False, 5)] + [
    ((1, 2, s, d), dtype, causal, window)
    for dtype in (torch.bfloat16, torch.float32) for d in (32, 64, 128, 256)
    for s in (1, 63, 1000, 4096)
    for causal, window in ((True, None), (False, None), (True, 1024))]


@pytest.mark.parametrize("shape,dtype,causal,window", _K7_CASES)
def test_flash_attention_kernel_within_tolerance(cuda, shape, dtype, causal,
                                                 window):
    gen = torch.Generator().manual_seed(shape[2])
    q_, k_, v_ = (torch.randn(shape, generator=gen).to(dtype).to(cuda)
                  for _ in range(3))
    before = flash_attention.launches
    got = flash_attention(q_, k_, v_, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    # Against the plain version in float32 from the same inputs: the kernel
    # works in float32 and rounds a bf16 output once (half a bf16 ulp), so
    # bf16 is held to one ulp (2^-7 of the value) plus 1e-4 for float32
    # sums in another order; float32 to the JAX tests' 2e-5.
    want = flash_attention_plain(q_.float(), k_.float(), v_.float(),
                                 causal=causal, window=window)
    atol, rtol = (1e-4, 2 ** -7) if dtype == torch.bfloat16 else (2e-5, 2e-5)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dynamic_a", [False, True])
def test_lm_cuda_session_equals_torch_ref(cuda, dynamic_a):
    from repro_torch.models import model as M
    cfg = configs.get("qwen3-1.7b", smoke=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    out = {}
    for be in ("cuda", "torch_ref"):
        sess = repro_torch.compile(cfg, uniform_policy(8, 8,
                                                       dynamic_a=dynamic_a),
                                   mode="serve_packed", backend=be,
                                   params=params, device=cuda)
        before = (bitserial_matmul.launches, bitserial_matmul_dynamic.launches)
        logits, cache = sess.prefill(tokens)
        step, _ = sess.decode(logits[:, 0].argmax(-1), 16, cache)
        torch.cuda.synchronize()
        if be == "cuda":
            launched = (bitserial_matmul.launches - before[0],
                        bitserial_matmul_dynamic.launches - before[1])
            n = 2 * (7 * cfg.n_layers + 1)
            assert launched == ((0, n) if dynamic_a else (n, 0))
        out[be] = (logits, step)
    assert torch.equal(out["cuda"][0], out["torch_ref"][0])
    assert torch.equal(out["cuda"][1], out["torch_ref"][1])


def _engine_session(cuda, policy, guarded=False):
    return repro_torch.compile(configs.get("qwen3-1.7b", smoke=True), policy,
                               mode="serve_packed", backend="cuda",
                               device=cuda, guarded=guarded)


def _engine_prompts(n=3):
    import numpy as np
    rng = np.random.default_rng(11)
    return [rng.integers(1, 256, size=(24 + 8 * j,)).astype(np.int32)
            for j in range(n)]


@pytest.mark.parametrize("dynamic_a", [False, True])
def test_engine_streams_and_logits_equal_solo(cuda, dynamic_a):
    """The batching engine on the card: every stream, and every batched
    decode row's logits, equal a solo batch-1 generate over the pool's
    cache length (K1 at M = max_batch on its skinny route, or K3)."""
    import dataclasses

    import numpy as np
    from repro_torch.runtime.batching import BatchingEngine
    sess = _engine_session(cuda, uniform_policy(8, 8, dynamic_a=dynamic_a))
    prompts, gen, max_seq = _engine_prompts(), 5, 64
    solo_rows = []
    for p in prompts:
        logits, cache = sess.prefill(p[None, :], sess.init_cache(1, max_seq))
        tok = logits[:, 0].argmax(-1)
        rows = [tok]
        for i in range(gen - 1):
            logits, cache = sess.decode(tok, len(p) + i, cache)
            rows.append(logits[0])
            tok = logits.argmax(-1)
        solo_rows.append(rows)
    seen, engine = [], []
    decode = sess._decode

    def recorded(params, token, pos, cache):
        logits, cache = decode(params, token, pos, cache)
        for slot, req in engine[0].active.items():
            seen.append((req.request_id, req.n_generated, logits[slot]))
        return logits, cache
    eng = BatchingEngine(dataclasses.replace(sess, _decode=recorded),
                         max_batch=4, max_seq=max_seq)
    engine.append(eng)
    hs = [eng.submit(p, gen) for p in prompts]
    eng.run(max_steps=50)
    for j, (h, p) in enumerate(zip(hs, prompts)):
        want = sess.generate(p[None, :], gen, max_seq=max_seq)[0]
        assert np.array_equal(h.result(timeout=30.0), want), j
    assert len(seen) == len(prompts) * (gen - 1)
    for rid, idx, row in seen:
        assert torch.equal(row, solo_rows[rid][idx]), (rid, idx)


def test_engine_guarded_supervised_watchdog_and_restart(cuda):
    """Guarded + supervised, decoding on the watchdog's thread: the same
    streams, no fallback; a transient backend fault in a decode restarts
    and replays to the same streams."""
    import numpy as np
    from repro_torch.runtime import ServingSupervisor, faults
    from repro_torch.runtime.batching import BatchingEngine
    from repro_torch.runtime.supervisor import TransientWorkerError
    plain = _engine_session(cuda, uniform_policy(8, 8))
    sess = _engine_session(cuda, uniform_policy(8, 8), guarded=True)
    prompts = _engine_prompts()
    want = [plain.generate(p[None, :], 5)[0] for p in prompts]
    eng = BatchingEngine(ServingSupervisor(sess), max_batch=4,
                         step_timeout_s=60.0)
    hs = [eng.submit(p, 5) for p in prompts]
    eng.step()
    faults.reset()
    try:
        with faults.inject("backend.op", exc=TransientWorkerError("lost"),
                           times=1, match="matmul_planes") as fault:
            eng.run(max_steps=50)
    finally:
        leaked = faults.active_points()
        faults.reset()
    assert not leaked and fault.fired == 1
    assert eng.stats.n_engine_restarts == 1
    for h, w in zip(hs, want):
        assert np.array_equal(h.result(timeout=30.0), w)
    assert sess.plan.fallback_report() == {}
    eng.drain()


def test_guarded_kernel_failure_raises_on_the_card(cuda):
    """A kernel that fails to build on CUDA tensors raises a typed
    compile error, through the guarded session, the supervisor (even with
    a rebuild hook) and the engine; no op falls back to ``torch_ref``."""
    import numpy as np
    from repro_torch.api import guards
    from repro_torch.runtime import ServingSupervisor, faults
    from repro_torch.runtime.batching import BatchingEngine
    sess = _engine_session(cuda, uniform_policy(8, 8), guarded=True)
    prompts = _engine_prompts(2)
    rebuilt = []
    sup = ServingSupervisor(sess, rebuild=lambda name: rebuilt.append(name))
    eng = BatchingEngine(sess, max_batch=2)
    hs = [eng.submit(p, 4) for p in prompts]
    eng.step()                             # both prefilled, one decode
    faults.reset()
    try:
        with faults.inject("backend.op",
                           exc=RuntimeError("kernel build failed: nvcc "
                                            "exited 1"),
                           times=None, match=":cuda"):
            with pytest.raises(guards.BackendCompileError):
                sess.generate(prompts[0][None, :], 2)
            with pytest.raises(guards.BackendCompileError):
                sup.generate(prompts[0][None, :], 2)
            with pytest.raises(guards.BackendCompileError):
                eng.run(max_steps=10)
    finally:
        leaked = faults.active_points()
        faults.reset()
    assert not leaked and rebuilt == []
    assert sess.plan.fallback_report() == {}
    assert sup.stats.n_session_fallbacks == 0 and sup.state == "failed"
    for h in hs:
        assert h.state == "failed"
    want = sess.generate(prompts[0][None, :], 2)     # the kernels serve again
    assert np.array_equal(want, _engine_session(
        cuda, uniform_policy(8, 8)).generate(prompts[0][None, :], 2))


def test_fingerprint_on_the_card_equals_the_cpu_one(cuda):
    """The same packed tree fingerprints alike on the card (each leaf
    copied to the host) and on the CPU, and a bit flipped on the card is
    caught and named."""
    from repro_torch.api import guards
    from repro_torch.core import integrity
    from repro_torch.models import model as M
    cfg = configs.get("qwen3-1.7b", smoke=True)
    dense = M.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    on_card, on_cpu = (repro_torch.compile(cfg, uniform_policy(8, 8),
                                           mode="serve_packed", params=dense,
                                           device=dev)
                       for dev in (cuda, "cpu"))
    assert on_card.fingerprint == on_cpu.fingerprint
    assert on_card.verify_integrity() == len(on_card.fingerprint.leaves)
    clean = on_card.params
    on_card.params, leaf = integrity.flip_one_bit(clean)
    with pytest.raises(guards.WeightIntegrityError, match=leaf):
        on_card.verify_integrity()
    on_card.params = clean


def test_audit_on_the_card_quarantines_nothing(cuda, tmp_path):
    """A silent corruption of request 0 on the card is caught by the
    ``torch_ref`` oracle (the plain versions on the card, off the serving
    path) and bundled; the quarantine demotes nothing -- the kernels keep
    serving, and the next request is clean."""
    import warnings

    import numpy as np
    from repro_torch.runtime import faults
    from repro_torch.runtime.batching import BatchingEngine
    plain = _engine_session(cuda, uniform_policy(8, 8))
    sess = _engine_session(cuda, uniform_policy(8, 8), guarded=True)
    prompts = _engine_prompts(2)
    eng = BatchingEngine(sess, max_batch=2, audit_rate=1.0,
                         audit_bundle_dir=str(tmp_path))
    faults.reset()
    try:
        with faults.inject("backend.silent_corrupt", times=None,
                           match="matmul_planes:cuda"):
            h0 = eng.submit(prompts[0], 4)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                eng.run(max_steps=20)
    finally:
        leaked = faults.active_points()
        faults.reset()
    assert not leaked
    h1 = eng.submit(prompts[1], 4)
    eng.run(max_steps=20)
    st = eng.stats
    assert (st.n_audits, st.n_divergences, st.n_quarantines) == (2, 1, 1)
    assert sess.plan.fallback_report() == {}
    assert sess.plan.backend.quarantine("probe", device=cuda) == 0
    assert eng.health()["state"] == "degraded"
    assert not np.array_equal(h0.result(timeout=30.0),
                              plain.generate(prompts[0][None, :], 4,
                                             max_seq=eng.max_seq)[0])
    assert np.array_equal(h1.result(timeout=30.0),
                          plain.generate(prompts[1][None, :], 4,
                                         max_seq=eng.max_seq)[0])
    assert len(list(tmp_path.glob("*.npz"))) == 1
    eng.drain()


def test_rms_norm_row_equals_the_row_alone_on_the_card(cuda):
    """A decode batch's RMSNorm row equals the row normalised alone, at
    every batch size the engine takes (PyTorch's CUDA reduction picks its
    thread layout by the row count below 16 rows)."""
    from repro_torch.models import layers as L
    g = torch.Generator(device="cuda").manual_seed(11)
    for trial in range(50):
        for b in (2, 3, 4, 8, 15, 16, 17):
            x = (torch.randn((b, 1, 2048), generator=g, device=cuda)
                 * (1 + 20 * trial / 50)).to(torch.bfloat16)
            gamma = (torch.randn(2048, generator=g, device=cuda)
                     * 0.1).to(torch.bfloat16)
            out = L.rms_norm(x, gamma)
            for r in range(b):
                assert torch.equal(out[r:r + 1], L.rms_norm(x[r:r + 1], gamma))


@pytest.mark.parametrize("s_", [128, 1024, 1025, 4100, 32768])
@pytest.mark.parametrize("extreme", [False, True])
def test_int8_dot_on_the_card_equals_the_cpu(cuda, s_, extreme):
    """attn_int8's integer product on the card equals the CPU's, and the
    exact product (float64: every sum is an integer below 2^53), bit for
    bit, on both sides of its 1024-long runs; PV's operand shapes at 8
    rows of the LM's 8 KV heads."""
    from repro_torch.models import attention as A
    g = torch.Generator().manual_seed(s_)
    if extreme:
        p_ = torch.full((8, 8, 2, s_), 127, dtype=torch.int8)
        v = torch.full((8, 8, s_, 128), -128, dtype=torch.int8)
    else:
        p_ = torch.randint(0, 128, (8, 8, 2, s_), generator=g,
                           dtype=torch.int8)
        v = torch.randint(-128, 128, (8, 8, s_, 128), generator=g,
                          dtype=torch.int8)
    got = A.int8_dot(p_.to(cuda), v.to(cuda)).cpu()
    assert got.dtype == torch.int32
    assert torch.equal(got, A.int8_dot(p_, v))
    exact = torch.matmul(p_.double(), v.double())
    assert torch.equal(got.double(), exact)


@pytest.mark.parametrize("change", [{}, dict(kv_cache_bits=8),
                                    dict(kv_cache_bits=8, attn_int8=True)])
def test_decode_attend_row_equals_the_row_alone_on_the_card(cuda, change):
    """Each decode route on the card, at the LM's head layout and a cache
    of 2048: a row attended with seven others equals the row alone."""
    from repro_torch.models import attention as A
    cfg = A.AttnConfig(d_model=2048, n_heads=16, n_kv_heads=8, d_head=128,
                       **change)
    g = torch.Generator(device="cuda").manual_seed(12)
    cache = A.init_cache(cfg, 8, 2048, device=cuda)
    for key in ("k", "v"):
        if cache[key].dtype == torch.int8:
            cache[key].copy_(torch.randint(-128, 128, cache[key].shape,
                                           generator=g, device=cuda,
                                           dtype=torch.int8))
            cache[key + "_scale"].uniform_(0.005, 0.05, generator=g)
        else:
            cache[key].copy_(torch.randn(cache[key].shape, generator=g,
                                         device=cuda))
    pos = torch.tensor([100, 2047, 700, 1500, 5, 2047, 1024, 333],
                       dtype=torch.int32, device=cuda)
    for b in range(8):
        cache["slot_pos"][b, :int(pos[b]) + 1] = torch.arange(
            int(pos[b]) + 1, device=cuda)
    q_ = torch.randn((8, 1, 16, 128), generator=g,
                     device=cuda).to(torch.bfloat16)
    out = A.decode_attend(q_, cache, cfg, pos)
    for b in range(8):
        one = {k: v[b:b + 1] for k, v in cache.items()}
        assert torch.equal(out[b:b + 1],
                           A.decode_attend(q_[b:b + 1], one, cfg, int(pos[b])))


def _moe_packed(cuda):
    """deepseek-moe-16b's MoE block (64 experts of 2048 x 1408, top 6, 2
    shared), random seed-5 weights packed at (8, 8) on the card, and a
    plan for its shared experts."""
    from repro_torch.api.plan import build_plan
    from repro_torch.models import model as M, moe
    cfg = configs.get("deepseek-moe-16b").moe
    p = moe.init(cfg, torch.Generator(device=cuda).manual_seed(5))
    p = M.convert_tree(p, uniform_policy(8, 8), "serve_packed", root=("ffn",))
    return cfg, p, build_plan(None, uniform_policy(8, 8), "serve_packed",
                              "cuda")


@pytest.mark.parametrize("op", ["router", "experts", "apply"])
def test_moe_row_equals_the_row_alone_on_the_card(cuda, op):
    """deepseek's MoE at a decode batch of 8 on the card: the router's
    logits and routing, the packed experts' products and the block's
    output give each row the bits of the row run alone."""
    from repro_torch.models import moe
    cfg, p, plan = _moe_packed(cuda)
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn((8, 1, cfg.d_model), generator=g,
                    device=cuda).to(torch.bfloat16)
    buf = torch.randn((8, cfg.n_experts, 1, cfg.d_model), generator=g,
                      device=cuda).to(torch.bfloat16)

    def run(rows):
        if op == "router":
            logits = moe.router_logits(x[rows], p["router"]["w"])
            return (logits,) + moe._route(logits, cfg)[:2]   # aux: batch-wide
        if op == "experts":
            return (moe._expert_mm(buf[rows], p, "w_gate"),)
        return (moe.apply(p, cfg, x[rows], plan),)
    batched = run(slice(None))
    for b in range(8):
        for got, want in zip(batched, run(slice(b, b + 1))):
            assert torch.equal(got[b:b + 1], want)


def test_ssm_decode_row_equals_the_row_alone_on_the_card(cuda):
    """mamba2-370m's block decoding a batch of 8 on the card (random
    seed-7 weights packed at (8, 8), a random conv history and state):
    each row's output and updated cache equal the row decoded alone."""
    from repro_torch.api.plan import build_plan
    from repro_torch.models import model as M, ssm
    cfg = configs.get("mamba2-370m").ssm
    g = torch.Generator(device=cuda).manual_seed(7)
    p = M.convert_tree(ssm.init(cfg, g), uniform_policy(8, 8),
                       "serve_packed")
    plan = build_plan(None, uniform_policy(8, 8), "serve_packed", "cuda")
    cache = ssm.init_cache(cfg, 8, device=cuda)
    cache["conv"].copy_(torch.randn(cache["conv"].shape, generator=g,
                                    device=cuda))
    cache["state"].copy_(torch.randn(cache["state"].shape, generator=g,
                                     device=cuda))
    x = torch.randn((8, 1, cfg.d_model), generator=g,
                    device=cuda).to(torch.bfloat16)
    rows = [{k: v[b:b + 1].clone() for k, v in cache.items()}
            for b in range(8)]
    out = ssm.apply_decode(p, cfg, x, plan, cache)
    for b in range(8):
        alone = ssm.apply_decode(p, cfg, x[b:b + 1], plan, rows[b])
        assert torch.equal(out[b:b + 1], alone)
        for key in cache:
            assert torch.equal(cache[key][b:b + 1], rows[b][key])


# -- training ---------------------------------------------------------------

def _train_case(device, mode):
    """qwen3-1.7b smoke: seed-0 params drawn on the CPU, a numpy-seed-0
    batch of 2 x 32; the loss, parts and gradients on ``device``."""
    import numpy as np

    from repro_torch import interop
    from repro_torch.api.plan import build_plan
    from repro_torch.launch.train import batch_on, value_and_grad
    from repro_torch.models import model as M
    cfg = configs.get("qwen3-1.7b", smoke=True)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab, size=(2, 32)) for k in
             ("tokens", "labels")}
    params = interop.params_from_numpy(M.init_params(cfg), device)
    return value_and_grad(params, cfg, batch_on(batch, device),
                          build_plan(cfg, uniform_policy(8, 8), mode))


@pytest.mark.parametrize("mode", ["dense", "fake_quant"])
def test_train_loss_and_grads_on_the_card_equal_the_cpu(cuda, mode):
    """The smoke LM's loss within 1e-2 relative and every gradient within
    5% of its leaf's max (the CPU parity tests' bounds against JAX) on
    the card against the same computation on the CPU."""
    from repro_torch import interop
    want, got = _train_case("cpu", mode), _train_case(cuda, mode)
    assert abs(float(got[0]) - float(want[0])) <= 1e-2 * abs(float(want[0]))
    w = interop.flatten_with_paths(want[2])
    g = interop.flatten_with_paths(got[2])
    for key in w:
        assert g[key].is_cuda
        diff = (g[key].cpu().float() - w[key].float()).abs().max()
        assert float(diff) <= 0.05 * float(w[key].float().abs().max()), key


def test_train_step_on_the_card_counts_as_its_dry_run(cuda):
    """One smoke train step (qwen3 at 4 layers, 2 x 32 int32 tokens and
    labels, float32 moments) on the card under the op analyzer counts
    what ``dryrun.train_counts`` counts, kernels none, and its backward,
    which autograd runs on its CUDA device thread, is counted: the step's
    operations are three times the forward's, within 1%."""
    import dataclasses

    from repro_torch.api.plan import build_plan
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.launch import dryrun, train as T
    from repro_torch.launch.opanalysis import OpAnalysis
    from repro_torch.models import model as M
    from repro_torch.optim import Schedule
    cfg = dataclasses.replace(configs.get("qwen3-1.7b", smoke=True),
                              n_layers=4, remat="none")
    tc = T.TrainConfig(sched=Schedule(warmup_steps=2, total_steps=8))
    state, _ = T.make_train_state(cfg, tc, device=cuda)
    plan = build_plan(cfg, uniform_policy(8, 8), "dense")
    batch = {k: torch.as_tensor(v, dtype=torch.int32, device=cuda)
             for k, v in synthetic_batch(DataConfig(
                 vocab=cfg.vocab, seq_len=32, global_batch=2), 0).items()}
    with OpAnalysis(arguments=(state, batch)) as a:
        T.make_train_step(cfg, plan, tc)(state, batch)
    torch.cuda.synchronize()
    with torch.no_grad(), OpAnalysis(memory=False) as fwd:
        M.loss_fn(state["params"], cfg, T.batch_on(batch, cuda), plan)
    assert a.totals().counts() == \
        dryrun.train_counts(cfg, "dense", 2, 32).counts()
    assert a.totals().kernels == {}
    assert a.totals().flops / fwd.totals().flops == pytest.approx(3, rel=0.01)


@pytest.mark.parametrize("window", [None, 80])
def test_flash_vjp_on_the_card_equals_autograd(cuda, window):
    """FlashAttention's dQ/dK/dV on the card against autograd through
    ``chunked_attention``, float32 [2, 256, 4, 64], blocks of 64 (window
    80 walks the span route), within 1e-4 + 1e-4 |want|."""
    from repro_torch.models import attention as attn
    g = torch.Generator(device=cuda).manual_seed(11)
    q_, k_, v_, do = (torch.randn((2, 256, 4, 64), generator=g, device=cuda)
                      for _ in range(4))
    grads = []
    for flash in (True, False):
        leaves = [t.clone().requires_grad_(True) for t in (q_, k_, v_)]
        if flash:
            out = attn.flash_attention(*leaves, True, window, 64, 64)
        else:
            out = attn.chunked_attention(*leaves, causal=True, window=window,
                                         bq=64, bk=64)
        grads.append(torch.autograd.grad(out, leaves, do))
    for a, b in zip(*grads):
        assert bool(((a - b).abs() <= 1e-4 + 1e-4 * b.abs()).all())


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_step_on_the_card_equals_the_cpu(cuda, moments):
    """One AdamW step (clipped) on the card against the CPU: params,
    moments and grad norm within 1e-6 of the value or of the leaf's max."""
    from repro_torch import interop, optim
    cfg = optim.AdamWConfig(moment_dtype=moments, grad_clip=0.5)
    gen = torch.Generator().manual_seed(12)
    params = {"w": torch.randn((64, 32), generator=gen),
              "g": torch.randn((32,), generator=gen)}
    grads = interop.tree_map(lambda p: torch.randn(p.shape, generator=gen),
                             params)
    out = {}
    for dev in ("cpu", cuda):
        p = interop.params_from_numpy(params, dev)
        new_p, opt, m = optim.adamw_update(
            p, interop.params_from_numpy(grads, dev), optim.adamw_init(p, cfg),
            cfg, torch.tensor(1e-3, device=dev))
        out[str(dev)] = (interop.flatten_with_paths(
            {"p": new_p, "mu": opt["mu"], "nu": opt["nu"]}), m["grad_norm"])
    (want, wn), (got, gn) = out["cpu"], out[str(cuda)]
    assert abs(float(gn) - float(wn)) <= 1e-6 * float(wn)
    for key in want:
        w, g = want[key].float(), got[key].cpu().float()
        bound = 1e-6 * (w.abs() + w.abs().max())
        assert bool(((g - w).abs() <= bound).all()), key


def test_world_size_1_mesh_on_nccl_equals_the_unmeshed_session(cuda):
    """A (1, 1) mesh of one rank on NCCL (``repro_torch.dist``): the
    meshed smoke LM's prefill and decode logits equal the unmeshed
    session's bit for bit, through K1 on the card."""
    import socket

    import torch.distributed as dist

    from repro_torch.dist import init_process
    from repro_torch.launch.mesh import make_host_mesh
    cfg = configs.get("qwen3-1.7b", smoke=True)
    toks = torch.randint(0, cfg.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(3))
    plain = repro_torch.compile(cfg, uniform_policy(8, 8),
                                mode="serve_packed")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    assert init_process(0, 1, port, "cuda") == "nccl"
    try:
        meshed = repro_torch.compile(cfg, uniform_policy(8, 8),
                                     mode="serve_packed",
                                     mesh=make_host_mesh(1, 1))
        launches = bitserial_matmul.launches
        a, ca = plain.prefill(toks, plain.init_cache(2, 32))
        b, cb = meshed.prefill(toks, meshed.init_cache(2, 32))
        assert torch.equal(a, b)
        tok = torch.argmax(a[:, 0], -1)
        for i in range(3):
            a, ca = plain.decode(tok, 16 + i, ca)
            b, cb = meshed.decode(tok, 16 + i, cb)
            assert torch.equal(a, b)
            tok = torch.argmax(a, -1)
        assert bitserial_matmul.launches - launches == 2 * 4 * 15
    finally:
        dist.destroy_process_group()
