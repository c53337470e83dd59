"""Port vs reference: decode attention over the linear cache (CPU).

The reference runs its Pallas kernel in interpret mode; the port runs the
kernel's plain version. Both compute the f32 scores, the exp / sum softmax
and the weighted sum of V on the same bf16 inputs, in different summation
orders: max |diff| <= 1e-5 * max |ref|.

The card kernel splits the cache rows across blocks and merges the splits'
softmax partials; its split picker and that arithmetic, written out in
torch, are held here to the plain version and the reference at 1e-5 of
max |v| (f32 sums in another order).
"""

import ml_dtypes
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from exllamav2_tpu.ops.decode_attn import decode_attention as ref_attention

from exllamav2_tpu_torch.ops import decode_attn as TA
from exllamav2_tpu_torch.interop import to_tensor

L, B, HQ, HKV, S, D = 2, 2, 8, 2, 512, 64
LIMIT = 256


def _inputs(seed):
    rng = np.random.default_rng(seed)

    def bf16(shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(ml_dtypes.bfloat16)

    return bf16((B, HQ, D)), bf16((L, B, HKV, S, D)), bf16((L, B, HKV, S, D))


@pytest.mark.parametrize("past_len", [0, 100, LIMIT - 1])
@pytest.mark.parametrize("softcap,window", [(0.0, 0), (5.0, 0), (0.0, 64),
                                            (30.0, 17)])
def test_decode_attention_matches_reference(past_len, softcap, window):
    q, k, v = _inputs(past_len + int(softcap) + window)
    layer, scale = 1, D ** -0.5
    ref = np.asarray(ref_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), layer,
        jnp.int32(past_len), LIMIT, scale, softcap, window))
    got = TA.decode_attention(*(to_tensor(a, "cpu") for a in (q, k, v)),
                              layer, past_len, LIMIT, scale, softcap,
                              window).numpy()
    assert got.shape == ref.shape == (B, HQ, D)
    err = np.abs(got - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), err


def test_decode_attention_cpu_counts_no_launch():
    q, k, v = _inputs(0)
    before = TA.LAUNCHES["decode_attn"]
    TA.decode_attention(*(to_tensor(a, "cpu") for a in (q, k, v)), 0, 3,
                        256, 0.125)
    assert TA.LAUNCHES["decode_attn"] == before


# ---------------------------------------------------------------------------
# The split of csrc/decode_attn.cu (flash-decoding), checked without a card:
# the split picker, and the split-and-combine softmax written out in torch
# from the kernel's formula.
# ---------------------------------------------------------------------------

SMS = 132                                   # SMs of an H100 SXM


@pytest.mark.parametrize("hkv", [1, 2, 8, 32])
@pytest.mark.parametrize("limit", [256, 512, 1024, 2048, 4096])
def test_split_count_fills_the_card_at_batch_1(hkv, limit):
    splits, per = TA.split_count(1, hkv, limit, SMS)
    assert per % 32 == 0 and 1 <= splits <= TA.MAX_SPLITS
    assert splits * per >= limit > (splits - 1) * per   # no split is idle
    # about three blocks per SM, unless the rows (32 a split) run out first
    rows_cap = min(TA.MAX_SPLITS, -(-limit // 32))
    assert hkv * splits >= min(SMS, hkv * rows_cap)
    assert splits > 1


@pytest.mark.parametrize("batch,hkv", [(1, 32), (4, 8), (16, 32)])
def test_split_count_follows_the_bucket_not_past_len(batch, hkv):
    from exllamav2_tpu_torch.models.model import _limit_bucket
    by_bucket = {}
    for past in range(0, 2048, 7):
        limit = _limit_bucket(past + 1, 2048)
        by_bucket.setdefault(limit, set()).add(
            TA.split_count(batch, hkv, limit, SMS))
    assert all(len(v) == 1 for v in by_bucket.values()), by_bucket
    # a full batch of 16 x 32 KV heads needs no split at the first bucket
    if batch == 16:
        assert TA.split_count(batch, hkv, 256, SMS) == (1, 256)


def _split_attention(q, k, v, layer, past_len, limit, scale, softcap, window,
                     splits, per):
    """The kernel's arithmetic in torch: per split an online-softmax partial
    (max m_s, sum l_s, unnormalised acc_s; an empty split gives -inf, 0),
    then M = max m_s, L = sum l_s e^(m_s - M), out = sum acc_s e^(m_s - M)
    / L over the splits in order."""
    b, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    kk = k[layer, :, :, :limit].float()
    vv = v[layer, :, :, :limit].float()
    sc = torch.einsum("bhgd,bhld->bhgl", q.float().reshape(b, hkv, g, d),
                      kk) * scale
    if softcap > 0.0:
        sc = torch.tanh(sc * (1.0 / softcap)) * softcap
    pos = torch.arange(limit)
    valid = pos <= past_len
    if window > 0:
        valid = valid & (pos > past_len - window)
    parts = []
    for i in range(splits):
        rows = slice(i * per, min((i + 1) * per, limit))
        live = valid[rows]
        if not live.any():
            parts.append((torch.full((b, hkv, g), -torch.inf),
                          torch.zeros((b, hkv, g)), None))
            continue
        s = sc[..., rows].masked_fill(~live, -torch.inf)
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        parts.append((m, p.sum(dim=-1),
                      torch.einsum("bhgl,bhld->bhgd", p, vv[:, :, rows])))
    big_m = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    out = torch.zeros((b, hkv, g, d))
    big_l = torch.zeros((b, hkv, g))
    for m, l, acc in parts:
        e = torch.where(m == -torch.inf, torch.zeros_like(m),
                        torch.exp(m - big_m))
        big_l = big_l + l * e
        if acc is not None:
            out = out + acc * e[..., None]
    return (out / big_l[..., None]).reshape(b, hq, d)


@pytest.mark.parametrize("past_len,window", [(0, 0), (31, 0), (32, 0),
                                             (100, 0), (LIMIT - 1, 0),
                                             (200, 50), (255, 17)])
@pytest.mark.parametrize("softcap", [0.0, 5.0])
def test_split_softmax_matches_plain_and_reference(past_len, window,
                                                   softcap):
    q, k, v = _inputs(1000 + past_len + window)
    layer, scale = 1, D ** -0.5
    splits, per = TA.split_count(B, HKV, LIMIT, SMS)
    assert splits > 1
    qt, kt, vt = (to_tensor(a, "cpu") for a in (q, k, v))
    got = _split_attention(qt, kt, vt, layer, past_len, LIMIT, scale,
                           softcap, window, splits, per).numpy()
    plain = TA.decode_attention_plain(qt, kt, vt, layer, past_len, LIMIT,
                                      scale, softcap, window).numpy()
    ref = np.asarray(ref_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), layer,
        jnp.int32(past_len), LIMIT, scale, softcap, window))
    vmax = np.abs(v[layer].astype(np.float32)).max()
    assert np.abs(got - plain).max() <= 1e-5 * vmax
    assert np.abs(got - ref).max() <= 1e-5 * vmax


@pytest.mark.parametrize("g,d,want", [
    (48, 128, (48, 1, 3)), (22, 128, (22, 1, 2)), (17, 128, (17, 1, 2)),
    (16, 128, (16, 1, 1)), (8, 256, (8, 1, 1)), (40, 256, (40, 1, 3)),
    (1, 64, (1, 1, 0)), (64, 32, (64, 1, 4))])
def test_head_chunks_cover_every_query_head_once(g, d, want):
    """Kernels 2 and 3 take any number of query heads a KV head: tile_plan
    (which took over from head_chunks) gives (heads a block, blocks a KV
    head, m16 tiles), one block of all G heads up to 64 on the mma
    template, one head on the CUDA-core template; the kernels' block index
    (batch, KV head, block) -> first query head reaches every query head
    exactly once, each under its own KV head, and its q / out elements at
    head_dim d once (more G and D in tests/test_torch_gqa_tiles.py)."""
    heads, blocks, mt = TA.tile_plan(g)
    assert (heads, blocks, mt) == want
    assert (blocks - 1) * heads < g <= heads * blocks
    b, hkv = 2, 3
    hq = hkv * g
    seen, elems = [], []
    for bh in range(b * hkv * blocks):
        bb, h, c = bh // (hkv * blocks), bh // blocks % hkv, bh % blocks
        n = min(heads, g - c * heads)
        head0 = bb * hq + h * g + c * heads
        seen += [(head0 + i, h) for i in range(n)]
        elems += range(head0 * d, (head0 + n) * d)
    assert sorted(i for i, _ in seen) == list(range(b * hq))
    assert all(i % hq // g == h for i, h in seen)
    assert sorted(elems) == list(range(b * hq * d))


def test_multi_query_48_heads_matches_reference():
    """StarCoder-15B's 48 query heads on one KV head (d = 128, the card's
    kernels in one block of three m16 tiles): the plain version against
    the reference at 1e-5 of max |ref|."""
    rng = np.random.default_rng(48)

    def bf16(shape):
        return rng.standard_normal(shape).astype(ml_dtypes.bfloat16)

    q, k, v = bf16((2, 48, 128)), bf16((1, 2, 1, 256, 128)), \
        bf16((1, 2, 1, 256, 128))
    got = TA.decode_attention(*(to_tensor(a, "cpu") for a in (q, k, v)), 0,
                              200, 256, 128 ** -0.5).numpy()
    ref = np.asarray(ref_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), 0, jnp.int32(200), 256,
                                   128 ** -0.5, 0.0, 0))
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
