"""Port vs reference: decode attention over the linear cache (CPU).

The reference runs its Pallas kernel in interpret mode; the port runs the
kernel's plain version. Both compute the f32 scores, the exp / sum softmax
and the weighted sum of V on the same bf16 inputs, in different summation
orders: max |diff| <= 1e-5 * max |ref|.
"""

import ml_dtypes
import numpy as np
import pytest
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
