"""FPx weight emulation, port against reference (CPU):
exllamav2_tpu_torch/experimental/fpx.py against exllamav2_tpu/experimental/fpx.py
on the same numpy-seeded inputs.

* fpx_round: bitwise equal f32 outputs at e2m1, e2m3, e3m2, e4m3 and e5m2,
  on inputs that hold f32 denormals, the format's own denormals, exact ties
  of both grids, overflow past max-normal and signed zeros.
* fpxify_tensor on bf16 weights: within 1 bf16 ulp of the reference's.
* fpxify of a tiny dense model: logits within 1e-5 of max |logit|; the
  caller's weights are not touched and quantized linears are left alone.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from exllamav2_tpu.experimental import fpx as R
from exllamav2_tpu.models.model import Model as RefModel
from exllamav2_tpu.utils.testing import make_tiny_llama as ref_make_tiny

from exllamav2_tpu_torch.experimental import fpx as P
from exllamav2_tpu_torch.models.model import Model
from exllamav2_tpu_torch.quant.qtensor import QuantLinear

FORMATS = [(2, 1), (2, 3), (3, 2), (4, 3), (5, 2)]


def _inputs(ebits, mbits, seed=0):
    rng = np.random.default_rng(seed)
    bias = (1 << (ebits - 1)) - 1
    min_normal = 2.0 ** (1 - bias)
    q_den = min_normal * 2.0 ** -mbits
    spread = rng.standard_normal(4096) * np.exp(rng.uniform(-14, 8, 4096))
    ties_den = (np.arange(-40, 40) + 0.5) * q_den          # half a quantum
    ties_norm = min_normal * (1 + (np.arange(2 ** mbits) + 0.5)
                              / 2 ** mbits)
    special = [0.0, -0.0, 1e-40, -1e-40, 1e-45, 3e-39, 1e30, -1e30,
               3.4e38, -3.4e38, min_normal, -q_den]
    return np.concatenate([spread, ties_den, ties_norm, -ties_norm,
                           special]).astype(np.float32)


@pytest.mark.parametrize("ebits,mbits", FORMATS)
def test_fpx_round_bitwise(ebits, mbits):
    x = _inputs(ebits, mbits)
    want = np.asarray(R.fpx_round(jnp.asarray(x), ebits, mbits))
    got = P.fpx_round(torch.from_numpy(x), ebits, mbits).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("ebits,mbits", FORMATS)
def test_fpxify_tensor_within_one_ulp(ebits, mbits):
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((96, 160)) * 0.05).astype(np.float32)
    w[3] *= 40.0                            # one row of a far larger scale
    want = np.asarray(R.fpxify_tensor(jnp.asarray(w, jnp.bfloat16), ebits,
                                      mbits).astype(jnp.float32))
    got = P.fpxify_tensor(torch.from_numpy(w).bfloat16(), ebits, mbits)
    assert got.dtype == torch.bfloat16
    # one bf16 ulp of the value (2^-7 relative to its binade)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got.float().numpy() - want) <= ulp).all()


@pytest.fixture(scope="module")
def dense_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("fpx_model"))
    ref_make_tiny(d, quant=None, seed=3, vocab=256, hidden=128, layers=2,
                  heads=4, kv_heads=2, inter=256, max_pos=512)
    return d


@pytest.mark.parametrize("ebits,mbits", [(4, 3), (3, 2), (2, 1)])
def test_fpxify_model_logits_match_reference(dense_dir, ebits, mbits):
    ids = np.array([[3, 17, 200, 9, 41, 5]], np.int32)
    ref = RefModel.from_dir(dense_dir)
    rm = RefModel(R.fpxify(ref.weights, ebits, mbits), ref.static, ref.config)
    lg_ref, _ = rm.forward(ids, rm.new_cache(batch=1, max_seq=16), 0)
    lg_ref = np.asarray(lg_ref, np.float32)

    model = Model.from_dir(dense_dir, device="cpu")
    before = model.weights.layers[0].mlp.up.weight.clone()
    pm = Model(P.fpxify(model.weights, ebits, mbits), model.static,
               model.config)
    lg, _ = pm.forward(ids, pm.new_cache(batch=1, max_seq=16), 0)
    err = np.abs(lg.numpy() - lg_ref).max() / np.abs(lg_ref).max()
    assert err <= 1e-5, err
    # the caller's model is untouched, the copy's linears are rounded
    assert torch.equal(model.weights.layers[0].mlp.up.weight, before)
    assert not torch.equal(pm.weights.layers[0].mlp.up.weight, before)


def test_fpxify_leaves_quantized_linears_alone(tmp_path):
    d = str(tmp_path / "q")
    ref_make_tiny(d, quant="exl2", seed=4, vocab=256, hidden=128, layers=1,
                  heads=4, kv_heads=2, inter=256)
    model = Model.from_dir(d, device="cpu")
    out = P.fpxify(model.weights, 3, 2)
    lw, lo = model.weights.layers[0], out.layers[0]
    for name in ("q", "k", "v", "o"):
        assert isinstance(getattr(lo.attn, name), QuantLinear)
        assert getattr(lo.attn, name) is getattr(lw.attn, name)
    assert lo.mlp.down is lw.mlp.down
