"""Rank reduction, port against reference (CPU):
exllamav2_tpu_torch/utils/rank_reduce.py against
exllamav2_tpu/utils/rank_reduce.py.

* rank_reduce_weight at fractions 0.25, 0.5 and 1.0: within 1e-5 of max
  |reference| (the port's SVD in f64 against numpy's in f32: measured up to
  4.7e-7; torch's f32 SVD was 1.15e-5 away at a quarter of the rank).
* rank_reduce_linear: the bias kept, quantized linears refused.
* rank_reduce_model at a quarter of the rank on the trained fixture, then
  greedy decoding: the same tokens as the reference's generate_greedy on
  its reduced weights (and not the full model's).
"""

import os

import numpy as np
import pytest
import torch

from exllamav2_tpu.models.model import Model as RefModel
from exllamav2_tpu.utils import rank_reduce as R

from exllamav2_tpu_torch.models.model import Model
from exllamav2_tpu_torch.quant.qtensor import DenseLinear
from exllamav2_tpu_torch.utils import rank_reduce as P
from exllamav2_tpu_torch.utils.testing import make_tiny_llama

TRAINED = os.path.join(os.path.dirname(__file__), "fixtures", "trained_tiny")


@pytest.mark.parametrize("fraction", [0.25, 0.5, 1.0])
@pytest.mark.parametrize("shape", [(96, 160), (160, 64)])
def test_rank_reduce_weight_matches_reference(fraction, shape):
    rng = np.random.default_rng(7)
    w = rng.standard_normal(shape).astype(np.float32)
    want = R.rank_reduce_weight(w, fraction)
    got = P.rank_reduce_weight(torch.from_numpy(w), fraction)
    assert got.shape == want.shape and got.dtype == torch.float32
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-5, err
    if fraction == 1.0:
        assert np.abs(got.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def test_rank_reduce_linear_keeps_bias_and_refuses_quantized(tmp_path):
    rng = np.random.default_rng(8)
    w = torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32))
    b = torch.arange(48, dtype=torch.float32).bfloat16()
    lin = P.rank_reduce_linear(DenseLinear(w.bfloat16(), b), 0.5)
    assert isinstance(lin, DenseLinear) and lin.bias is b
    assert lin.weight.dtype == torch.bfloat16
    assert torch.equal(lin.weight, P.rank_reduce_weight(
        w.bfloat16(), 0.5).bfloat16())
    d = make_tiny_llama(str(tmp_path / "q"), quant="exl2", seed=1, layers=1)
    q = Model.from_dir(d, device="cpu").weights.layers[0].mlp.up
    with pytest.raises(TypeError):
        P.rank_reduce_linear(q, 0.5)


@pytest.mark.parametrize("which", [("mlp",), ("mlp", "attn")])
def test_rank_reduce_model_greedy_matches_reference(which):
    torch.set_num_threads(1)
    prompt = np.array([[1, 50, 99, 7, 23, 104]], np.int32)
    ref = RefModel.from_dir(TRAINED)
    ref.weights = R.rank_reduce_model(ref.weights, 0.25, which)
    want = np.asarray(ref.generate_greedy(prompt, 12))

    model = Model.from_dir(TRAINED, device="cpu")
    full = model.generate_greedy(prompt, 12)
    model.weights = P.rank_reduce_model(model.weights, 0.25, which)
    got = model.generate_greedy(prompt, 12)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, full)      # the reduction mattered
