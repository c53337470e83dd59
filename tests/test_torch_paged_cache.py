"""Port vs reference: the paged KV cache (cache_paged.py), bit for bit.

Both packages allocate the same pool, append the same numpy-seeded bf16 K/V
through the same shuffled block tables -- decode-sized appends (b*t <= 64,
the reference's per-row path) and prefill-sized ones that cross page
boundaries (its per-page path) -- then gather and copy pages. Every byte of
the pools, the gathered K/V and the copies must be equal, for every kind.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from exllamav2_tpu.cache_paged import PagedKVCache as RefPaged

from exllamav2_tpu_torch.cache_paged import PAGE_SIZE, PagedKVCache

KINDS = ["bf16", "fp8", "q4", "q8", "q6"]
L, P, H, D = 2, 10, 2, 64


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        if a.dtype in (torch.bfloat16, torch.float8_e5m2):
            return a.contiguous().view(torch.uint8).numpy()
        return a.numpy()
    a = np.asarray(a)
    if a.dtype.name in ("bfloat16", "float8_e5m2"):
        return np.ascontiguousarray(a).view(np.uint8)
    return a


def _assert_pools_equal(tc, rc):
    for name in ("k_data", "k_scales", "v_data", "v_scales"):
        t, r = getattr(tc, name), getattr(rc, name)
        if r is None:
            assert t is None, name
            continue
        assert tuple(t.shape) == tuple(r.shape), name
        np.testing.assert_array_equal(_bits(t), _bits(r), err_msg=name)


def _kv(rng, b, t):
    x = rng.standard_normal((2, b, t, H, D)) * 0.7
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(xj).view(np.int16).copy()).view(
        torch.bfloat16)
    return (xj[0], xj[1]), (xt[0], xt[1])


def _append(rc, tc, layer, bt, seqlens, rng, t):
    (rk, rv), (tk, tv) = _kv(rng, bt.shape[0], t)
    rc = rc.append(layer, jnp.asarray(bt), jnp.asarray(seqlens), rk, rv)
    out = tc.append(layer, torch.from_numpy(bt), torch.from_numpy(seqlens),
                    tk, tv)
    assert out is tc                                   # in place
    return rc


@pytest.mark.parametrize("kind", KINDS)
def test_alloc_matches_reference(kind):
    rc = RefPaged.alloc(L, P, H, D, kind)
    tc = PagedKVCache.alloc(L, P, H, D, kind, device="cpu")
    _assert_pools_equal(tc, rc)
    assert (tc.num_pages, tc.num_layers, tc.kv_heads, tc.page_size) == \
        (rc.num_pages, rc.num_layers, rc.kv_heads, PAGE_SIZE)


@pytest.mark.parametrize("kind", KINDS)
def test_append_gather_copy_bitwise(kind):
    rng = np.random.default_rng(11)
    rc = RefPaged.alloc(L, P, H, D, kind)
    tc = PagedKVCache.alloc(L, P, H, D, kind, device="cpu")
    bt = np.array([[7, 2, 9, 4], [3, 8, 1, 6]], np.int32)   # shuffled pages
    # prefill-sized (b*t > 64), crossing page boundaries from odd offsets
    rc = _append(rc, tc, 1, bt, np.array([100, 250], np.int32), rng, 300)
    _assert_pools_equal(tc, rc)
    # decode-sized: b*t <= 64 at a page edge and mid-page, both layers
    rc = _append(rc, tc, 0, bt, np.array([255, 511], np.int32), rng, 1)
    rc = _append(rc, tc, 1, bt, np.array([400, 550], np.int32), rng, 16)
    _assert_pools_equal(tc, rc)

    for layer in (0, 1):
        rk, rv = rc.gather_layer(layer, jnp.asarray(bt))
        tk, tv = tc.gather_layer(layer, torch.from_numpy(bt))
        np.testing.assert_array_equal(_bits(tk), _bits(rk))
        np.testing.assert_array_equal(_bits(tv), _bits(rv))

    rc = rc.copy_pages(jnp.asarray([2, 9], jnp.int32),
                       jnp.asarray([5, 0], jnp.int32))
    assert tc.copy_pages([2, 9], [5, 0]) is tc
    _assert_pools_equal(tc, rc)


def test_pad_rows_write_the_null_page():
    """Pad rows of a bucketed batch (all-zero block table) write page 0 with
    duplicate indices: allowed, and no live page changes."""
    tc = PagedKVCache.alloc(1, 4, H, D, "q4", device="cpu")
    bt = torch.tensor([[2, 3], [0, 0], [0, 0]], dtype=torch.int32)
    k = torch.randn((3, 1, H, D)).bfloat16()
    before = tc.k_data.clone()
    tc.append(0, bt, torch.tensor([5, 0, 0], dtype=torch.int32), k, k)
    changed = (tc.k_data != before).any(dim=-1).nonzero()[:, 2].unique()
    assert set(changed.tolist()) <= {2 * PAGE_SIZE + 5, 0}
    # positions past the table's width go to the null page too
    live = tc.k_data[0, :, PAGE_SIZE:].clone()
    tc.append(0, bt[:1], torch.tensor([2 * PAGE_SIZE], dtype=torch.int32),
              k[:1], k[:1])
    assert torch.equal(tc.k_data[0, :, PAGE_SIZE:], live)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedKVCache.alloc(1, 2, 1, 32)
    with pytest.raises(ValueError, match="cache kind"):
        PagedKVCache.alloc(1, 2, 1, 32, "q3", device="cpu")
