"""Port vs reference: on-device sampling (ops/sampling.py) and the sampler
settings (generator/sampler.py), on the CPU.

`sample` is fed the reference's own uniform draws (`u`), so the sampled
tokens must be IDENTICAL over a grid of settings, with probabilities and
mirostat state within 1e-6; penalties and DRY agree within 1e-6; the packed
mask unpacks equally; stack_settings gives the same fields.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from exllamav2_tpu.generator import sampler as RS
from exllamav2_tpu.ops import sampling as RO

from exllamav2_tpu_torch.generator import sampler as TS
from exllamav2_tpu_torch.interop import sampling_params_from_reference
from exllamav2_tpu_torch.ops import sampling as TO

B, V = 6, 300

GRID = {
    "greedy": dict(temperature=0.0),
    "greedy_settings": dict(temperature=1.0, top_k=1, top_p=0.0),
    "top_k": dict(top_k=7, top_p=0.0),
    "top_p": dict(top_k=0, top_p=0.6),
    "min_p": dict(top_k=0, top_p=0.0, min_p=0.08),
    "top_a": dict(top_k=0, top_p=0.0, top_a=0.3),
    "tfs": dict(top_k=0, top_p=0.0, tfs=0.7),
    "typical": dict(top_k=0, top_p=0.0, typical=0.6),
    "mirostat": dict(top_k=0, top_p=0.0, mirostat=True, mirostat_tau=3.0,
                     mirostat_mu=5.0),
    "temperature_last": dict(temperature=1.7, temperature_last=True,
                             top_k=20, top_p=0.9),
    "dynamic_temperature": dict(top_k=0, top_p=0.0, min_temp=0.3,
                                max_temp=1.6, temp_exponent=1.5),
    "smoothing": dict(top_k=0, top_p=0.0, smoothing_factor=0.4),
    "xtc": dict(top_k=0, top_p=0.0, xtc_probability=1.0,
                xtc_threshold=0.02),
    "skew": dict(top_k=40, top_p=0.0, skew=1.5),
    "all_filters": dict(temperature=1.2, top_k=40, top_p=0.9, min_p=0.01,
                        tfs=0.95, typical=0.95, top_a=0.05),
}


def _logits(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    lg = rng.standard_normal((B, V)).astype(np.float32) * 2.5
    lg[:, :5] += 4.0                          # a few strong candidates
    lg[0, 10] = lg[0, 11]                     # an exact tie
    return lg


def _params(batch: int, **over):
    ref = RO.SamplingParams.defaults(batch, **over)
    ref_np = jax.tree_util.tree_map(np.asarray, ref)
    return ref, sampling_params_from_reference(ref_np, device="cpu")


_ref_sample = jax.jit(RO.sample, static_argnames=("return_top",))


@pytest.mark.parametrize("name", list(GRID))
def test_sample_tokens_identical(name):
    lg = _logits(len(name))
    rp, tp = _params(B, **GRID[name])
    key = jax.random.PRNGKey(len(name))
    u = np.array(jax.random.uniform(key, (B, 1)))
    rt, rpr, rmu = _ref_sample(key, jnp.asarray(lg), rp)
    tt, tpr, tmu = TO.sample(torch.from_numpy(lg), tp, u=torch.from_numpy(u))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(rt))
    np.testing.assert_allclose(tpr.numpy(), np.asarray(rpr), atol=1e-6)
    np.testing.assert_allclose(tmu.numpy(), np.asarray(rmu), atol=1e-6,
                               rtol=1e-6)


def test_sample_filter_xtc_mask_and_top():
    lg = _logits(99)
    rng = np.random.default_rng(5)
    allow = rng.random((B, V)) < 0.7
    xtc = rng.random((B, V)) < 0.5
    rp, tp = _params(B, top_k=0, top_p=0.0, xtc_probability=0.8,
                     xtc_threshold=0.01)
    key = jax.random.PRNGKey(3)
    u = np.array(jax.random.uniform(key, (B, 1)))
    ref = _ref_sample(key, jnp.asarray(lg), rp, jnp.asarray(allow),
                      jnp.asarray(xtc), return_top=5)
    got = TO.sample(torch.from_numpy(lg), tp,
                    logit_filter=torch.from_numpy(allow),
                    xtc_mask=torch.from_numpy(xtc), return_top=5,
                    u=torch.from_numpy(u))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    assert allow[np.arange(B), got[0].numpy()].all()
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-6)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), atol=1e-6)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))


def test_sample_draws_from_the_generator():
    lg = torch.from_numpy(_logits(1))
    _, tp = _params(B, top_k=0, top_p=0.0)
    g1 = torch.Generator().manual_seed(4)
    g2 = torch.Generator().manual_seed(4)
    a = TO.sample(lg, tp, generator=g1)[0]
    b = TO.sample(lg, tp, generator=g2)[0]
    assert torch.equal(a, b) and a.dtype == torch.int32


def _history():
    rng = np.random.default_rng(8)
    seq = rng.integers(0, 40, (B, 64)).astype(np.int32)
    seq[:, 30:40] = seq[:, 10:20]             # repeated n-grams for DRY
    seq_len = np.array([64, 50, 40, 33, 1, 0], np.int32)
    for i, n in enumerate(seq_len):
        seq[i, n:] = -1
    return seq, seq_len


@pytest.mark.parametrize("over", [
    dict(rep_penalty=1.3),
    dict(rep_penalty=1.2, rep_range=16, rep_decay=8),
    dict(freq_penalty=0.4, pres_penalty=0.7, rep_range=20),
    dict(rep_penalty=1.1, freq_penalty=0.2, pres_penalty=0.3, rep_range=10,
         rep_decay=0)])
def test_apply_penalties_matches_reference(over):
    lg = _logits(2)
    seq, seq_len = _history()
    rp, tp = _params(B, **over)
    ref = RO.apply_penalties(jnp.asarray(lg), jnp.asarray(seq),
                             jnp.asarray(seq_len), rp)
    got = TO.apply_penalties(torch.from_numpy(lg), torch.from_numpy(seq),
                             torch.from_numpy(seq_len), tp)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("dry_range", [0, 24])
def test_apply_dry_matches_reference(dry_range):
    lg = _logits(3)
    seq, seq_len = _history()
    mult = np.full(B, 0.8, np.float32)
    mult[2] = 0.0
    base = np.full(B, 1.75, np.float32)
    allowed = np.full(B, 2, np.int32)
    rng_ = np.full(B, dry_range, np.int32)
    breakers = np.full((B, 8), -1, np.int32)
    breakers[1, :2] = [seq[1, 12], seq[1, 33]]
    args = (mult, base, allowed, rng_, breakers)
    ref = RO.apply_dry(jnp.asarray(lg), jnp.asarray(seq),
                       jnp.asarray(seq_len), *map(jnp.asarray, args))
    got = TO.apply_dry(torch.from_numpy(lg), torch.from_numpy(seq),
                       torch.from_numpy(seq_len),
                       *map(torch.from_numpy, args))
    assert not np.array_equal(np.asarray(ref), lg)          # DRY bites
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-6)


def test_unpack_mask_equal():
    allow = np.random.default_rng(4).random((3, 101)) < 0.5
    packed = np.packbits(allow, axis=1, bitorder="little")
    ref = np.asarray(RO.unpack_mask(jnp.asarray(packed), 101))
    got = TO.unpack_mask(torch.from_numpy(packed), 101)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), allow)


def test_stack_settings_field_by_field():
    ref_s = [RS.Settings(), RS.Settings.greedy(),
             RS.Settings(temperature=0.5, top_k=3, mirostat=True,
                         dry_sequence_breakers={5, 1, 9}, dry_range=7,
                         token_repetition_range=12)]
    tor_s = [TS.Settings(**dataclasses.asdict(s)) for s in ref_s]
    for mu in (None, [0.5, 0.0, 4.0]):
        ref = RS.stack_settings(ref_s, mu)
        got = TS.stack_settings(tor_s, mu, device="cpu")
        for f in dataclasses.fields(RO.SamplingParams):
            r, t = np.asarray(getattr(ref, f.name)), getattr(got, f.name)
            assert t.dtype == {np.dtype(np.float32): torch.float32,
                               np.dtype(np.int32): torch.int32,
                               np.dtype(np.bool_): torch.bool}[r.dtype], f.name
            np.testing.assert_array_equal(t.numpy(), r, err_msg=f.name)
    assert TS.Settings.greedy().clone() == TS.Settings.greedy()


def test_defaults_match_reference():
    ref = jax.tree_util.tree_map(np.asarray, RO.SamplingParams.defaults(
        3, top_k=9, mirostat=True))
    got = TO.SamplingParams.defaults(3, device="cpu", top_k=9, mirostat=True)
    for f in dataclasses.fields(RO.SamplingParams):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      getattr(ref, f.name), err_msg=f.name)
