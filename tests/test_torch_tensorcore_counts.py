"""PyTorch port: the arithmetic of the tensor-core K2-K5, on the CPU.

CUDA kernels cannot run here, so plain-torch mirrors of what they compute
(``csrc/bitfold.cuh``, ``csrc/bitserial_matmul.cu``,
``csrc/bitserial_conv.cu``) are held against the JAX package's oracles
on the same numpy inputs, exactly (int32):

(a) the count-masked bit-transpose fold (``bitfold::trim8``, ``trim16``):
    for every count c in 1..Pw at Pw 8, 11 and 16, planes >= c masked off
    and each weight sign-extended from c bits; at Pw > 8 the lo slice
    unsigned and the hi slice the weight >> 8, i.e. the sign (0 or -1)
    wherever c <= 8;
(b) K3: a tile loads only the planes below its columns' largest count,
    folds every column at its own count (column groups of 12, 16 and 256)
    and multiplies lo and hi slices in wrapping int32;
(c) the conv kernel (``tcconv::conv_tc_kernel``) that K2, K4 and K5
    launch: the band staged with 16-byte aligned rows, the patches
    gathered in runs of 16/8/4/2/1 bytes through per-pixel and per-slot
    offset tables (conv1's C = 3, stride 2, k 1 and 5), in one chunk of
    the reduction or several, blocks of one or two images. K4 folds the
    packed planes at its counts, K2 at none (all Pw planes, against
    ``bitserial_conv_ref``); K5 moves its dense int8 weights into the
    tile by 8 x 8 byte transposes and truncates each gathered run at its
    pixel's window-group count (against the Pallas
    ``bitserial_conv_dynamic`` in interpret mode);
(d) K3's route (K1's, whatever the counts) and the conv kernel's
    shared-memory layout.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitpack as jbitpack, quantize as jq
from repro.kernels import ref as jref
from repro.kernels.bitserial_conv import (
    bitserial_conv_dynamic as jbitserial_conv_dynamic)
from repro_torch.kernels.bitserial_conv import (SMEM_BUDGET, TC_BM, TC_BN,
                                                band_geometry, conv_smem_bytes,
                                                conv_tc_chunk,
                                                conv_tc_images_per_block,
                                                conv_tc_layout)
from repro_torch.kernels.bitserial_matmul import SKINNY_MAX_M, _route

ONES = 0x0101010101010101


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _packed(rng, k, n, bits):
    wq = rng.integers(jq.qmin(bits), jq.qmax(bits) + 1,
                      size=(k, n)).astype(np.int32)
    return np.asarray(jbitpack.pack_weights(jnp.asarray(wq), bits))


def _jax_truncated(packed, counts, w_bits, w_group):
    """JAX's truncated weights [K, N]: the identity through its oracle."""
    k = packed.shape[1] * 8
    eye = jnp.eye(k, dtype=jnp.int8)
    return np.asarray(jref.bitserial_matmul_wgroup_ref(
        eye, jnp.asarray(packed), jnp.asarray(counts), w_bits, w_group))


# -- the kernels' fold, in plain torch ---------------------------------------

def _transpose8(x):
    """bit (r, c) at 8r + c -> 8c + r of int64 words (bitfold::transpose8)."""
    t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AA
    x = x ^ t ^ (t << 7)
    t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCC
    x = x ^ t ^ (t << 14)
    t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0
    return x ^ t ^ (t << 28)


def _sign_extend8(y, bits):
    """Each byte of y sign-extended from ``bits`` (a per-column tensor in
    1..8; 8 and above leave the byte as it is)."""
    b = bits.clamp(max=8)
    sign = (y >> (b - 1)) & ONES
    return torch.where(bits >= 8, y, y | sign * ((0xFF << b) & 0xFF))


def _trim8(w, c):
    """bitfold::trim8: planes >= c masked off, bytes sign-extended from c."""
    return _sign_extend8(w & ONES * ((1 << c) - 1), c)


def _trim16(lo, hi, c):
    """bitfold::trim16: the lo and hi words of a Pw > 8 column at count c."""
    lo8 = _trim8(lo, c.clamp(max=8))
    sign = ((lo8 >> 7) & ONES) * 0xFF
    small = c <= 8
    return (torch.where(small, lo8, lo),
            torch.where(small, sign, _trim8(hi, (c - 8).clamp(min=1))))


def _byte_words(rows, n_rows):
    """uint8 [R, K8, N] -> int64 words [K8, N]: byte i = rows[i], for i
    below n_rows (and 8; later rows read as zero): the byte transpose of
    8 rows of 8 columns (bitfold::transpose_bytes8)."""
    x = torch.zeros(rows.shape[1:], dtype=torch.int64)
    for i in range(min(n_rows, rows.shape[0], 8)):
        x |= rows[i].to(torch.int64) << (8 * i)
    return x


def _fold_words(planes, n_planes):
    """uint8 plane bytes [P, K8, N] -> int64 words [K8, N] of planes
    0..n_planes-1 (fewer than 8; later ones read as zero): byte r = row
    8 kb + r, plane i at bit i (bitfold::fold8)."""
    return _transpose8(_byte_words(planes, n_planes))


def _bytes(words, signed):
    """int64 words [K8, N] -> their bytes as rows [8 K8, N] (int32)."""
    rows = torch.stack([(words >> (8 * r)) & 0xFF for r in range(8)], dim=1)
    rows = rows.reshape(-1, words.shape[1]).to(torch.uint8)
    return (rows.view(torch.int8) if signed else rows).to(torch.int32)


def _fold_counts(packed, w_bits, col_counts, n_planes=None):
    """The fold of K3/K4 for packed uint8 [Pw, K8, N] with a count per column
    (int64 [N]): int32 weights [8 K8, N] at Pw <= 8, else the (lo, hi)
    slices. Only planes < n_planes (default: all) are loaded."""
    n_planes = w_bits if n_planes is None else n_planes
    lo = _fold_words(packed, n_planes)
    if w_bits <= 8:
        return _bytes(_trim8(lo, col_counts), signed=True)
    hi = _fold_words(packed[8:], n_planes - 8)
    lo, hi = _trim16(lo, hi, col_counts)
    return _bytes(lo, signed=False), _bytes(hi, signed=True)


def _weights(folded, w_bits):
    if w_bits <= 8:
        return folded
    lo, hi = folded
    return hi * 256 + lo


def _narrow(v):
    return v.to(torch.int64).to(torch.int32)


def _products(x, folded, w_bits):
    """x int [M, K] against the fold: one int32 accumulator, or lo (s8 x u8)
    and hi (s8 x s8) recombined as hi * 256 + lo, wrapping as int32."""
    x64 = x.to(torch.int64)
    if w_bits <= 8:
        return _narrow(x64 @ folded.to(torch.int64))
    lo, hi = folded
    acc_lo = _narrow(x64 @ lo.to(torch.int64)).to(torch.int64)
    acc_hi = _narrow(x64 @ hi.to(torch.int64)).to(torch.int64)
    return _narrow(acc_hi * 256 + acc_lo)


def _column_counts(counts, group, n, w_bits):
    return torch.repeat_interleave(
        torch.as_tensor(counts, dtype=torch.int64).clamp(1, w_bits),
        group)[:n]


# -- (a) the count-masked fold -----------------------------------------------

@pytest.mark.parametrize("w_bits", [8, 11, 16])
def test_count_masked_fold_every_count(w_bits):
    rng = np.random.default_rng(w_bits)
    packed = _packed(rng, 40, 24, w_bits)
    for c in range(1, w_bits + 1):
        counts = np.full(1, c, dtype=np.int32)
        folded = _fold_counts(_t(packed), w_bits,
                              _column_counts(counts, 24, 24, w_bits))
        want = _jax_truncated(packed, counts, w_bits, 24)
        np.testing.assert_array_equal(_weights(folded, w_bits)[:40].numpy(),
                                      want)
        if w_bits > 8 and c <= 8:
            lo, hi = folded
            # hi is the truncated weight's sign, not planes 8..Pw-1
            assert torch.equal(hi, -(lo >= 128).to(torch.int32))
            assert bool((packed[8:] != 0).any())


@pytest.mark.parametrize("w_bits", [8, 11, 16])
@pytest.mark.parametrize("bn", [1, 12, 16])
def test_count_masked_fold_per_column(w_bits, bn):
    rng = np.random.default_rng(100 * w_bits + bn)
    n = 40
    packed = _packed(rng, 64, n, w_bits)
    counts = rng.integers(1, w_bits + 1, size=-(-n // bn)).astype(np.int32)
    folded = _fold_counts(_t(packed), w_bits,
                          _column_counts(counts, bn, n, w_bits))
    np.testing.assert_array_equal(_weights(folded, w_bits).numpy(),
                                  _jax_truncated(packed, counts, w_bits, bn))


# -- (b) K3 ------------------------------------------------------------------

def _k3_mirror(x, packed, counts, w_bits, bn, tile_n):
    """K3's kernel over column tiles of ``tile_n``: each tile loads the
    planes below its largest count and folds every column at its own."""
    n = packed.shape[2]
    cols = _column_counts(counts, bn, n, w_bits)
    out = []
    for n0 in range(0, n, tile_n):
        c = cols[n0:n0 + tile_n]
        folded = _fold_counts(packed[:, :, n0:n0 + tile_n], w_bits, c,
                              n_planes=int(c.max()))
        out.append(_products(x, folded, w_bits))
    return torch.cat(out, dim=1)


@pytest.mark.parametrize("w_bits", [8, 11, 16])
@pytest.mark.parametrize("bn", [12, 16, 256])
@pytest.mark.parametrize("m", [10, 40])
@pytest.mark.parametrize("kind", ["random", "full", "ones"])
def test_k3_mirror_equals_reference(w_bits, bn, m, kind):
    rng = np.random.default_rng(w_bits + bn + m)
    k, n = 136, 300
    x = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
    packed = _packed(rng, k, n, w_bits)
    groups = -(-n // bn)
    counts = {"random": rng.integers(1, w_bits + 1, size=groups),
              "full": np.full(groups, w_bits),
              "ones": np.ones(groups)}[kind].astype(np.int32)
    want = np.asarray(jref.bitserial_matmul_wgroup_ref(
        jnp.asarray(x), jnp.asarray(packed), jnp.asarray(counts), w_bits, bn))
    tile_n = 64 if _route(m, k, n, w_bits)[0] == "skinny" else 128
    got = _k3_mirror(_t(x), _t(packed), counts, w_bits, bn, tile_n)
    np.testing.assert_array_equal(got.numpy(), want)


def test_k3_mirror_wraps_like_int32():
    """K1's wrapping operands through K3's fold at full counts."""
    x = np.full((2, 6144), -128, dtype=np.int8)
    x[0, ::3] = 127
    wq = np.full((6144, 16), -2 ** 15, dtype=np.int32)
    wq[:, 1] = 2 ** 15 - 1
    packed = np.asarray(jbitpack.pack_weights(jnp.asarray(wq), 16))
    counts = np.full(1, 16, dtype=np.int32)
    want = np.asarray(jref.bitserial_matmul_wgroup_ref(
        jnp.asarray(x), jnp.asarray(packed), jnp.asarray(counts), 16, 16))
    assert (x.astype(np.int64) @ wq.astype(np.int64) != want).any()
    got = _k3_mirror(_t(x), _t(packed), counts, 16, 16, 64)
    np.testing.assert_array_equal(got.numpy(), want)


# -- (c) the conv kernel: K4, K2, K5 --------------------------------------

def _band(x_img, lay, r_in0):
    """Image [H, W, C] int8 -> the kernel's staged band bytes (uint8)."""
    h, w, c = x_img.shape
    in0 = lay["lpad"] + lay["pad"] * c
    band = torch.zeros(lay["band_rows"] * lay["row_ld"], dtype=torch.uint8)
    for r in range(lay["band_rows"]):
        gr = r_in0 + r
        if 0 <= gr < h:
            start = r * lay["row_ld"] + in0
            band[start:start + w * c] = x_img[gr].reshape(-1).view(torch.uint8)
    return band


def _gather(band, lay, *, c, kernel, stride, wo, p0, band_px, ch, kc,
            pcnt=None):
    """The tile's patches [TC_BM, kc] for reduction rows [ch kc, (ch+1) kc),
    slot by slot through the kernel's pix and k_off tables; with ``pcnt``
    (int64 [TC_BM], K5) each pixel's bytes truncated at its count, 8 bytes
    at a time (bitfold::trim8)."""
    kkc, run, vec = kernel * kernel * c, kernel * c, lay["vec"]
    pix = [p // wo * stride * lay["row_ld"] + lay["lpad"] + p % wo * stride * c
           if p < band_px else -1 for p in range(p0, p0 + TC_BM)]
    k_off = []
    for q in range(kc // vec):
        kk = ch * kc + q * vec
        k_off.append(kk // run * lay["row_ld"] + kk % run if kk < kkc else -1)
    a = torch.zeros((TC_BM, kc), dtype=torch.uint8)
    for r, po in enumerate(pix):
        for q, ko in enumerate(k_off):
            if po >= 0 and ko >= 0:
                a[r, q * vec:(q + 1) * vec] = band[po + ko:po + ko + vec]
    if pcnt is not None:
        words = _byte_words(a.reshape(TC_BM, kc // 8, 8).permute(2, 0, 1), 8)
        a = _bytes(_trim8(words, pcnt[:, None]).T, signed=True).T
        return a.contiguous()
    return a.view(torch.int8).to(torch.int32)


def _chunk(x, kernel, stride, rows_per_band, wide):
    """The wrappers' reduction rows per chunk for x [B, H, W, C]."""
    h, w, c = x.shape[1:]
    ho = -(-h // stride)
    rpb = band_geometry(ho, ho, rows_per_band, kernel, stride)[0]
    return conv_tc_chunk(h, w, c, kernel=kernel, stride=stride, rpb=rpb,
                         wide=wide)


def _tc_mirror(x, n, operand, *, kernel, stride, wide, rows_per_band, kc,
               trim=None):
    """``tcconv::conv_tc_kernel``: per (filter tile, band, block of ipb
    images) the B operand of each chunk, ``operand(n0, ch, kc)`` (int32
    [kc, cols], or the (lo, hi) slices where ``wide``), made once; per image
    of the block and pixel tile, the gathered patches times it, each
    pixel's bytes truncated at ``trim(img, window)`` where given (K5)."""
    b, h, w, c = x.shape
    ho, wo = -(-h // stride), -(-w // stride)
    rpb, nb, _ = band_geometry(ho, wo, rows_per_band, kernel, stride)
    lay = conv_tc_layout(w, c, kernel=kernel, stride=stride, rpb=rpb, kc=kc,
                         wide=wide)
    nchunks = -(-(-(-kernel * kernel * c // 32) * 32) // kc)
    ipb = conv_tc_images_per_block(rpb * wo)
    bits = 16 if wide else 8       # _products: the lo/hi route where wide
    out = torch.zeros((b, ho, wo, n), dtype=torch.int32)
    for n0 in range(0, n, TC_BN):
        cols = min(TC_BN, n - n0)
        for bi in range(nb):
            band_px = min(rpb, ho - bi * rpb) * wo
            for b0 in range(0, b, ipb):
                ops_ = [operand(n0, ch, kc) for ch in range(nchunks)]
                for img in range(b0, min(b, b0 + ipb)):
                    band = _band(x[img], lay, bi * rpb * stride - kernel // 2)
                    for p0 in range(0, band_px, TC_BM):
                        pcnt = None if trim is None else torch.tensor(
                            [trim(img, bi * rpb * wo + p) if p < band_px
                             else 8 for p in range(p0, p0 + TC_BM)])
                        acc = torch.zeros((TC_BM, cols), dtype=torch.int32)
                        for ch, op in enumerate(ops_):
                            a = _gather(band, lay, c=c, kernel=kernel,
                                        stride=stride, wo=wo, p0=p0,
                                        band_px=band_px, ch=ch, kc=kc,
                                        pcnt=pcnt)
                            acc = _narrow(acc.to(torch.int64)
                                          + _products(a, op, bits))
                        p = torch.arange(p0, min(p0 + TC_BM, band_px))
                        pr, pc = bi * rpb + p // wo, p % wo
                        out[img, pr, pc, n0:n0 + TC_BN] = acc[:len(p)]
    return out


def _rows_padded(w, kc, kernel, c):
    """w [K8 (or its packed rows), ...] along dim -2 zero-padded to the
    chunks' whole rows."""
    k8 = -(-kernel * kernel * c // 8)
    nchunks = -(-(-(-k8 * 8 // 32) * 32) // kc)
    rows = nchunks * kc // (8 if w.dim() == 3 else 1)
    pad = torch.zeros((*w.shape[:-2], rows - w.shape[-2], w.shape[-1]),
                      dtype=w.dtype)
    return torch.cat([w, pad], dim=-2)


def _k4_mirror(x, packed, counts, *, kernel, stride, w_bits, w_group=16,
               rows_per_band=None, kc=None):
    """K4 (and K2 where ``counts`` is None: every filter at Pw): each
    chunk's planes folded at the tile's counts, loading only the planes
    below the tile's largest."""
    n, c = packed.shape[2], x.shape[3]
    kc = kc or _chunk(x, kernel, stride, rows_per_band, w_bits > 8)
    planes = _rows_padded(packed, kc, kernel, c)
    cols = (torch.full((n,), w_bits, dtype=torch.int64) if counts is None
            else _column_counts(counts, w_group, n, w_bits))
    kb = kc // 8

    def operand(n0, ch, kc):
        c_tile = cols[n0:n0 + TC_BN]
        return _fold_counts(planes[:, ch * kb:(ch + 1) * kb, n0:n0 + TC_BN],
                            w_bits, c_tile, n_planes=int(c_tile.max()))
    return _tc_mirror(x, n, operand, kernel=kernel, stride=stride,
                      wide=w_bits > 8, rows_per_band=rows_per_band, kc=kc)


def _k5_mirror(x, wq, counts, *, kernel, stride, group, rows_per_band=None,
               kc=None):
    """K5: each chunk of the dense int8 weights moved into the tile by 8 x 8
    byte transposes (no fold), and each pixel's gathered bytes truncated
    at its window group's count, clamped to [1, 8], per image."""
    n, c = wq.shape[1], x.shape[3]
    kc = kc or _chunk(x, kernel, stride, rows_per_band, False)
    rows = _rows_padded(wq, kc, kernel, c).view(torch.uint8)
    cnt = torch.as_tensor(counts, dtype=torch.int64).clamp(1, 8)

    def operand(n0, ch, kc):
        chunk = rows[ch * kc:(ch + 1) * kc, n0:n0 + TC_BN]
        words = _byte_words(chunk.reshape(kc // 8, 8, -1).permute(1, 0, 2), 8)
        return _bytes(words, signed=True)

    return _tc_mirror(x, n, operand, kernel=kernel, stride=stride, wide=False,
                      rows_per_band=rows_per_band, kc=kc,
                      trim=lambda img, p: int(cnt[img, p // group]))


def _k4_case(seed, b, h, c, n, kernel, w_bits):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, size=(b, h, h, c)).astype(np.int8)
    return x, _packed(rng, kernel * kernel * c, n, w_bits)


def _jax_conv(x, packed, counts, kernel, stride, w_bits, w_group):
    return np.asarray(jref.bitserial_conv_wgroup_ref(
        jnp.asarray(x), jnp.asarray(packed), jnp.asarray(counts),
        kernel=kernel, stride=stride, w_bits=w_bits, w_group=w_group))


@pytest.mark.parametrize("h,c,kernel,stride", [
    (8, 3, 3, 1),       # conv1's C = 3: byte runs, K 27 padded to 32
    (9, 5, 3, 2),       # stride 2
    (9, 5, 5, 2),       # k 5, stride 2
    (6, 8, 1, 1),       # k 1, 8-byte runs
    (5, 32, 3, 1),      # 16-byte runs
])
@pytest.mark.parametrize("rows", [None, 3])
def test_k4_gather_is_the_im2col(h, c, kernel, stride, rows):
    """Every band's gathered tile rows equal the patches in (di, dj, c)
    order (JAX's window slices concatenated along channels)."""
    x, _ = _k4_case(h + c, 2, h, c, 8, kernel, 8)
    ho = wo = -(-h // stride)
    rpb, nb, _ = band_geometry(ho, wo, rows, kernel, stride)
    pad = kernel // 2
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    patches = np.concatenate(
        [np.asarray(s) for s in jref.conv_window_slices(xp, kernel, stride,
                                                        ho, wo)], axis=-1)
    kkc = kernel * kernel * c
    kc = -(-kkc // 32) * 32
    lay = conv_tc_layout(h, c, kernel=kernel, stride=stride, rpb=rpb, kc=kc,
                         wide=False)
    for img in range(2):
        for bi in range(nb):
            band_px = min(rpb, ho - bi * rpb) * wo
            band = _band(_t(x[img]), lay, bi * rpb * stride - pad)
            for p0 in range(0, band_px, TC_BM):
                a = _gather(band, lay, c=c, kernel=kernel, stride=stride,
                            wo=wo, p0=p0, band_px=band_px, ch=0, kc=kc)
                p = np.arange(p0, min(p0 + TC_BM, band_px))
                want = patches[img, bi * rpb + p // wo, p % wo]
                np.testing.assert_array_equal(a[:len(p), :kkc].numpy(), want)
                assert not a[:len(p), kkc:].any()       # K's zero padding
                assert not a[len(p):].any()             # rows past the band


@pytest.mark.parametrize("h,c,n,kernel,stride", [
    (8, 3, 32, 3, 1), (9, 5, 40, 3, 2), (7, 4, 24, 5, 2)])
@pytest.mark.parametrize("w_bits", [8, 11, 16])
@pytest.mark.parametrize("w_group", [16, 12])
def test_k4_mirror_equals_reference(h, c, n, kernel, stride, w_bits, w_group):
    x, packed = _k4_case(h + n + w_bits, 2, h, c, n, kernel, w_bits)
    counts = np.random.default_rng(w_group).integers(
        1, w_bits + 1, size=-(-n // w_group)).astype(np.int32)
    want = _jax_conv(x, packed, counts, kernel, stride, w_bits, w_group)
    for rows in (None, 3):
        got = _k4_mirror(_t(x), _t(packed), counts, kernel=kernel,
                         stride=stride, w_bits=w_bits, w_group=w_group,
                         rows_per_band=rows)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("w_bits", [8, 16])
@pytest.mark.parametrize("kc", [32, 64, 96])
def test_k4_mirror_in_chunks(w_bits, kc):
    """The chunked reduction (each chunk folded and gathered on its own)
    at K = 216, Pw 8 and 16: the loop the kernel runs where a filter tile's
    folded weights do not fit."""
    x, packed = _k4_case(kc + w_bits, 1, 5, 24, 20, 3, w_bits)
    counts = np.array([w_bits, 3], dtype=np.int32)
    got = _k4_mirror(_t(x), _t(packed), counts, kernel=3, stride=1,
                     w_bits=w_bits, w_group=16, kc=kc)
    np.testing.assert_array_equal(
        got.numpy(), _jax_conv(x, packed, counts, 3, 1, w_bits, 16))


# K2: the same kernel with no counts (every filter at all Pw planes), held
# against the static oracle: conv1's C = 3, stride 2, k 1 and 5, ragged N,
# and B = 3 at a one-tile band (blocks of two images, the last one short).
_K2_SHAPES = [(2, 8, 3, 32, 3, 1), (2, 9, 5, 40, 3, 2), (2, 7, 4, 24, 5, 2),
              (2, 6, 8, 10, 1, 1), (3, 8, 16, 24, 3, 1)]


@pytest.mark.parametrize("b,h,c,n,kernel,stride", _K2_SHAPES)
@pytest.mark.parametrize("w_bits", [4, 8, 11, 16])
def test_k2_mirror_equals_reference(b, h, c, n, kernel, stride, w_bits):
    x, packed = _k4_case(h + n + w_bits, b, h, c, n, kernel, w_bits)
    want = np.asarray(jref.bitserial_conv_ref(
        jnp.asarray(x), jnp.asarray(packed), kernel=kernel, stride=stride,
        w_bits=w_bits))
    for rows in (None, 3):
        got = _k4_mirror(_t(x), _t(packed), None, kernel=kernel,
                         stride=stride, w_bits=w_bits, rows_per_band=rows)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("w_bits", [8, 16])
@pytest.mark.parametrize("kc", [32, 64, 96])
def test_k2_mirror_in_chunks(w_bits, kc):
    x, packed = _k4_case(kc + w_bits + 1, 1, 5, 24, 20, 3, w_bits)
    got = _k4_mirror(_t(x), _t(packed), None, kernel=3, stride=1,
                     w_bits=w_bits, kc=kc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jref.bitserial_conv_ref(jnp.asarray(x), jnp.asarray(packed),
                                kernel=3, stride=1, w_bits=w_bits)))


def _k5_case(seed, b, h, c, n, kernel, stride, group, kind):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, size=(b, h, h, c)).astype(np.int8)
    k8 = -(-kernel * kernel * c // 8) * 8
    wq = rng.integers(-128, 128, size=(k8, n)).astype(np.int8)
    shape = (b, -(-(-(-h // stride)) ** 2 // group))
    counts = {"random": rng.integers(1, 9, size=shape),
              "full": np.full(shape, 8), "ones": np.ones(shape)}[kind]
    return x, wq, counts.astype(np.int32)


def _jax_conv_dynamic(x, wq, counts, kernel, stride, group):
    return np.asarray(jbitserial_conv_dynamic(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(counts), kernel=kernel,
        stride=stride, a_bits=8, group_size=group))


# K5 against the Pallas kernel: conv1's C = 3, stride 2, k 1 and 5, ragged
# N, window groups that do not divide Wo, and B = 3 at a one-tile band.
_K5_SHAPES = [(2, 8, 3, 32, 3, 1, 16), (2, 9, 3, 24, 3, 1, 12),
              (2, 9, 5, 40, 3, 2, 8), (2, 7, 4, 24, 5, 2, 3),
              (2, 6, 8, 10, 1, 1, 16), (3, 8, 16, 24, 3, 1, 24)]


@pytest.mark.parametrize("b,h,c,n,kernel,stride,group", _K5_SHAPES)
@pytest.mark.parametrize("kind", ["random", "full", "ones"])
def test_k5_mirror_equals_pallas(b, h, c, n, kernel, stride, group, kind):
    x, wq, counts = _k5_case(h + c + n + len(kind), b, h, c, n, kernel,
                             stride, group, kind)
    want = _jax_conv_dynamic(x, wq, counts, kernel, stride, group)
    for rows in (None, 3):
        got = _k5_mirror(_t(x), _t(wq), counts, kernel=kernel, stride=stride,
                         group=group, rows_per_band=rows)
        np.testing.assert_array_equal(got.numpy(), want)
    if kind == "random":     # the counts really truncate
        assert not np.array_equal(want, _jax_conv_dynamic(
            x, wq, np.full_like(counts, 8), kernel, stride, group))


@pytest.mark.parametrize("kc", [32, 64, 96])
def test_k5_mirror_in_chunks(kc):
    """K = 216 in chunks: each chunk's dense rows transposed and its runs
    truncated on their own."""
    x, wq, counts = _k5_case(kc, 2, 5, 24, 20, 3, 1, 7, "random")
    got = _k5_mirror(_t(x), _t(wq), counts, kernel=3, stride=1, group=7,
                     kc=kc)
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_conv_dynamic(x, wq, counts, 3, 1, 7))


# -- (d) K3's route and the conv kernel's layout ------------------------------------------

@pytest.mark.parametrize("m,k,n", [
    (256, 2048, 256),      # path D fc0^T
    (10, 256, 256),        # path D fc1^T
    (256, 2048, 256),      # path W fc0
    (2048, 2048, 1024),    # LM dynamic_a q^T
    (6144, 2048, 1024),    # LM dynamic_a gate^T
    (151936, 2048, 8),     # LM dynamic_a head^T
    (10, 2040, 520), (1024, 2040, 520)])
@pytest.mark.parametrize("pw", [8, 11, 16])
def test_k3_route(m, k, n, pw):
    route, splits = _route(m, k, n, pw)
    assert route == ("skinny" if m <= SKINNY_MAX_M else "tile")
    bm, bn, bk = ((16, 64, 64) if route == "skinny" else
                  (64, 128, 64) if pw > 8 else (128, 128, 128))
    tiles = -(-k // bk)
    assert 1 <= splits <= tiles
    assert (splits - 1) * -(-tiles // splits) < tiles   # no empty split
    blocks = -(-m // bm) * -(-n // bn)
    assert blocks * splits >= min(2 * 132, blocks * tiles)


def test_k3_route_at_the_paths():
    assert _route(256, 2048, 256, 8) == ("tile", 16)    # path D fc0^T
    assert _route(10, 256, 256, 8) == ("skinny", 4)     # path D fc1^T
    assert _route(151936, 2048, 8, 8) == ("tile", 1)    # the LM head


@pytest.mark.parametrize("h,c,kernel,stride,rows", [
    (32, 3, 3, 1, None), (16, 32, 3, 1, None), (8, 64, 3, 1, None),
    (9, 5, 5, 2, 3), (6, 512, 3, 1, None), (224, 64, 3, 1, None)])
@pytest.mark.parametrize("wide", [False, True])
def test_k4_layout(h, c, kernel, stride, rows, wide):
    ho = -(-h // stride)
    rpb = band_geometry(ho, ho, rows, kernel, stride)[0]
    if rows is None and h == 224:   # the plan's band for a large map
        from repro_torch.api.plan import conv_rows_per_band
        rpb = conv_rows_per_band(h, h, c, kernel=kernel, stride=stride)
    kc = conv_tc_chunk(h, h, c, kernel=kernel, stride=stride, rpb=rpb,
                       wide=wide)
    lay = conv_tc_layout(h, c, kernel=kernel, stride=stride, rpb=rpb, kc=kc,
                         wide=wide)
    assert lay["bytes"] <= SMEM_BUDGET
    assert conv_smem_bytes(h, h, c, kernel=kernel, stride=stride,
                           rows_per_band=rpb) <= SMEM_BUDGET
    assert kc % 32 == 0 and lay["lds"] % 128 in (32, 96)
    assert lay["row_ld"] % 16 == 0
    assert (lay["lpad"] + lay["pad"] * c) % 16 == 0     # interior aligned
    assert c % lay["vec"] == 0 and lay["lpad"] % lay["vec"] == 0
    # The regions in order, each 16-byte aligned and clear of the next:
    # band, B (two slices where wide), patches / output tile, slot offsets,
    # filter counts, pixel offsets, then K5's [BM] pixel counts last.
    bands, slices = lay["band_rows"] * lay["row_ld"], 2 if wide else 1
    assert lay["b_off"] >= bands
    assert lay["a_off"] == lay["b_off"] + slices * TC_BN * lay["lds"]
    assert lay["koff_off"] >= lay["a_off"] + TC_BM * max(lay["lds"],
                                                         4 * TC_BN)
    assert lay["cnt_off"] >= lay["koff_off"] + 4 * (kc // lay["vec"])
    assert lay["pix_off"] >= lay["cnt_off"] + 4 * (TC_BN + 1)
    assert lay["pcnt_off"] == lay["pix_off"] + 4 * TC_BM
    assert lay["bytes"] == lay["pcnt_off"] + 4 * TC_BM
    assert all(lay[k] % 16 == 0 for k in ("b_off", "a_off", "koff_off",
                                          "cnt_off", "pix_off", "pcnt_off"))
    kp = -(-kernel * kernel * c // 32) * 32
    if kc < kp:     # chunked only where the whole K does not fit
        whole = conv_tc_layout(h, c, kernel=kernel, stride=stride, rpb=rpb,
                               kc=kp, wide=wide)
        assert whole["bytes"] > SMEM_BUDGET
    if h <= 32 and c <= 64:     # the paper CNN's convs: one chunk
        assert kc == kp
    if c == 512:                # K = 4608 does not fit at any band
        assert kc < kp


def test_k4_images_per_block():
    assert conv_tc_images_per_block(8 * 8) == 2        # conv3: one tile
    assert conv_tc_images_per_block(16 * 16) == 1      # conv2: four tiles
    assert conv_tc_images_per_block(32 * 32) == 1
