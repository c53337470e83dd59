"""The conversion end to end, port against reference (CPU).

One tiny Llama (hidden 128, 2 layers) is converted once by each package
(2 calibration rows of 64 tokens, 4.0 bpw, the head at 6 bits):

* the measurement: the same bit totals, errors within MEAS_TOL relative
  (the f32 products sum in another order: measured 2e-7); the same
  strategy;
* the output: the same keys, shapes and dtypes; q_scale, q_groups and
  q_invperm equal; q_weight and q_scale_max words that differ counted and
  at most WORD_FLIPS of them (a code rounds the other way where the
  Hessians part by an ulp: measured 18 of 6,144 words, all in the head);
* each output loads in both packages: the port's load of either output
  gives the reference's logits on it within LOGITS_TOL of max |logit|, as
  tests/test_torch_model.py holds checkpoints; the reference's logits on
  the two outputs within OUT_TOL of each other;
* the [STATUS] stage lines.

Then the port alone, mirroring tests/test_convert.py:96-260: sharded
output, Mixtral and Phi-3 sources, the quantized head, resume after a
crash, the group-size refusal, a quantized source refused; `python -m exllamav2_tpu_torch.convert
--device cpu` in a subprocess; and evals.perplexity against the
reference's on tests/fixtures/trained_tiny (dense, PPL_TOL relative), with
the converted fixture's perplexity beside it.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from exllamav2_tpu.convert.pipeline import convert_model as ref_convert
from exllamav2_tpu.evals import perplexity as ref_perplexity
from exllamav2_tpu.models.model import Model as RefModel
from exllamav2_tpu.utils.testing import make_tiny_llama as ref_make_tiny

from exllamav2_tpu_torch.convert.pipeline import (
    calibration_rows, convert_model)
from exllamav2_tpu_torch.evals import perplexity
from exllamav2_tpu_torch.models.model import Model
from exllamav2_tpu_torch.stloader import TensorFileMap
from exllamav2_tpu_torch.tokenizer import ByteTokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED = os.path.join(REPO, "tests", "fixtures", "trained_tiny")
MEAS_TOL = 1e-4
WORD_FLIPS = 0.01       # share of packed words that may differ
LOGITS_TOL = 1e-2
OUT_TOL = 0.05
PPL_TOL = 1e-3
TINY = dict(vocab=256, hidden=128, layers=2, heads=4, kv_heads=2, inter=256,
            max_pos=512)
CAL = dict(bits=4.0, cal_rows=2, cal_len=64)
IDS = np.array([[3, 17, 200, 9, 55, 123]], np.int32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(*a, **k):
    pass


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-9)


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    root = tmp_path_factory.mktemp("convert")
    src = ref_make_tiny(str(root / "src"), quant=None, seed=11, **TINY)
    ref_out, out = str(root / "ref"), str(root / "port")
    ref_convert(src, ref_out, progress=_quiet, **CAL)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        convert_model(src, out, progress=_quiet, status_output=True,
                      device="cpu", **CAL)
    return {"src": src, "ref": ref_out, "port": out,
            "stdout": log.getvalue()}


def _json(d, name):
    with open(os.path.join(d, name)) as f:
        return json.load(f)


def test_measurement_and_strategy_match_reference(converted):
    ref = _json(converted["ref"], "measurement.json")["layers"]
    got = _json(converted["port"], "measurement.json")["layers"]
    assert sorted(got) == sorted(ref) == ["0", "1"]
    for l in ref:
        for kind in ("attn", "mlp"):
            r, g = np.array(ref[l][kind]), np.array(got[l][kind])
            assert g.shape == r.shape == (10 if kind == "attn" else 9, 2)
            np.testing.assert_array_equal(g[:, 0], r[:, 0])
            assert _rel(g[:, 1], r[:, 1]) < MEAS_TOL, (l, kind)
    rj, gj = _json(converted["ref"], "job.json"), \
        _json(converted["port"], "job.json")
    assert gj == rj
    assert gj["stage"] == "done" and gj["group_size"] == 32


def test_tensors_match_reference(converted):
    ref, got = TensorFileMap(converted["ref"]), \
        TensorFileMap(converted["port"])
    try:
        assert sorted(got.keys()) == sorted(ref.keys())
        assert "lm_head.q_weight" in got and "lm_head.weight" not in got
        flips = words = 0
        for key in ref.keys():
            r, g = ref.get_tensor(key), got.get_tensor(key)
            assert g.shape == r.shape and g.dtype == r.dtype, key
            assert got.get_dtype(key) == ref.get_dtype(key), key
            if key.rsplit(".", 1)[1] in ("q_scale", "q_groups",
                                         "q_invperm"):
                np.testing.assert_array_equal(g, r, err_msg=key)
            elif key.rsplit(".", 1)[1] in ("q_weight", "q_scale_max"):
                flips += int((g != r).sum())
                words += r.size
            else:
                np.testing.assert_array_equal(g, r, err_msg=key)
        assert flips <= WORD_FLIPS * words, (flips, words)
    finally:
        ref.close()
        got.close()
    rc, gc = _json(converted["ref"], "config.json"), \
        _json(converted["port"], "config.json")
    assert gc == rc
    assert gc["quantization_config"]["quant_method"] == "exl2"


def _ref_logits(d):
    m = RefModel.from_dir(d)
    out, _ = m.forward(jnp.asarray(IDS), m.new_cache(batch=1, max_seq=16), 0)
    return np.asarray(out)


def _port_logits(d):
    m = Model.from_dir(d, device="cpu")
    assert m.config.quant_method == "exl2"
    out, _ = m.forward(IDS, m.new_cache(batch=1, max_seq=16), 0)
    return out.numpy()


def test_outputs_load_in_both_packages(converted):
    ref_on = {k: _ref_logits(converted[k]) for k in ("ref", "port")}
    for k in ("ref", "port"):
        got = _port_logits(converted[k])
        assert np.isfinite(got).all()
        assert _rel(got, ref_on[k]) < LOGITS_TOL, k
    assert _rel(ref_on["port"], ref_on["ref"]) < OUT_TOL
    # the conversion is close to its source (a wiring check at 4 bits on
    # random weights, as tests/test_convert.py:160-163)
    src = Model.from_dir(converted["src"], device="cpu")
    dense, _ = src.forward(IDS, src.new_cache(batch=1, max_seq=16), 0)
    assert _rel(ref_on["port"], dense.numpy()) < 0.5


def test_status_stages(converted):
    stages = [json.loads(line[8:-9])
              for line in converted["stdout"].splitlines()
              if line.startswith("[STATUS]") and line.endswith("[/STATUS]")]
    names = {s["stage"] for s in stages}
    assert {"Measuring", "Optimizing", "Quantizing", "Quantizing (head)",
            "Compiling"} <= names
    assert all(0.0 <= s["completion"] <= 1.0 for s in stages)
    assert [s["completion"] for s in stages
            if s["stage"] == "Quantizing"] == [0.5, 1.0]


# ---------------------------------------------------------------------------
# the port alone (tests/test_convert.py:96-260)
# ---------------------------------------------------------------------------

def _roundtrip(tmp_path, name, layers=1, **fixture_kw):
    src = ref_make_tiny(str(tmp_path / f"{name}_src"), quant=None, seed=13,
                        **dict(TINY, layers=layers), **fixture_kw)
    out = str(tmp_path / f"{name}_out")
    convert_model(src, out, head_bits=6, progress=_quiet, device="cpu",
                  **CAL)
    assert np.isfinite(_port_logits(out)).all()
    return out


def test_sharded_output(tmp_path):
    src = ref_make_tiny(str(tmp_path / "src"), quant=None, head_scale=6.0)
    out = str(tmp_path / "out")
    convert_model(src, out, progress=_quiet, shard_size_mb=0.2,
                  device="cpu", **CAL)
    idx = _json(out, "model.safetensors.index.json")
    assert not os.path.exists(os.path.join(out, "model.safetensors"))
    shards = sorted(set(idx["weight_map"].values()))
    assert len(shards) >= 2, shards
    assert all(os.path.exists(os.path.join(out, fn)) for fn in shards)
    assert np.isfinite(_port_logits(out)).all()


def test_convert_moe(tmp_path):
    out = _roundtrip(tmp_path, "moe", arch="MixtralForCausalLM",
                     extra_config={"num_local_experts": 2,
                                   "num_experts_per_tok": 2})
    tfm = TensorFileMap(out)
    assert "model.layers.0.block_sparse_moe.experts.1.w2.q_weight" in tfm
    assert "model.layers.0.block_sparse_moe.gate.weight" in tfm
    tfm.close()


def test_convert_phi3_fused(tmp_path):
    out = _roundtrip(tmp_path, "phi3", arch="Phi3ForCausalLM")
    tfm = TensorFileMap(out)
    assert "model.layers.0.self_attn.q_proj.q_weight" in tfm
    assert "model.layers.0.mlp.gate_proj.q_weight" in tfm
    assert "model.layers.0.self_attn.qkv_proj.weight" not in tfm
    tfm.close()


@pytest.mark.parametrize("head_bits", [6, 16])
def test_head_bits(tmp_path, head_bits):
    src = ref_make_tiny(str(tmp_path / "src"), quant=None, seed=13,
                        **dict(TINY, layers=1))
    out = str(tmp_path / "out")
    convert_model(src, out, head_bits=head_bits, progress=_quiet,
                  device="cpu", **CAL)
    tfm = TensorFileMap(out)
    assert ("lm_head.q_weight" in tfm) == (head_bits < 16)
    assert ("lm_head.weight" in tfm) == (head_bits == 16)
    tfm.close()
    assert _json(out, "config.json")["quantization_config"][
        "head_bits"] == head_bits


def test_resume_from_partial(tmp_path):
    src = ref_make_tiny(str(tmp_path / "rsrc"), quant=None, seed=14, **TINY)
    out = str(tmp_path / "rout")
    convert_model(src, out, progress=_quiet, device="cpu", **CAL)
    with open(os.path.join(out, "model.safetensors"), "rb") as f:
        whole = f.read()
    # a crash after layer 0 of the quantize stage
    os.remove(os.path.join(out, "model.safetensors"))
    os.remove(os.path.join(out, "quant", "layer_1.safetensors"))
    job = _json(out, "job.json")
    job["stage"] = "quantize"
    with open(os.path.join(out, "job.json"), "w") as f:
        json.dump(job, f)
    seen = []
    convert_model(src, out, progress=seen.append, device="cpu", **CAL)
    assert any("quantized layer 2/2" in m for m in seen)
    assert not any("quantized layer 1/2" in m for m in seen)
    # layer 1 saw the same states: the resumed output is the same file
    with open(os.path.join(out, "model.safetensors"), "rb") as f:
        assert f.read() == whole


def test_resume_rejects_group_size_change(tmp_path):
    src = ref_make_tiny(str(tmp_path / "src"), quant=None, seed=12,
                        **dict(TINY, layers=1))
    out = str(tmp_path / "out")
    convert_model(src, out, progress=_quiet, device="cpu", **CAL)
    with pytest.raises(ValueError, match="group_size"):
        convert_model(src, out, group_size=128, progress=_quiet,
                      device="cpu", **CAL)


def test_refuses_a_quantized_source(tmp_path):
    src = ref_make_tiny(str(tmp_path / "src"), quant="exl2", seed=16,
                        **dict(TINY, layers=1))
    with pytest.raises(ValueError, match="unquantized"):
        convert_model(src, str(tmp_path / "out"), progress=_quiet,
                      device="cpu", **CAL)


def test_cli_on_the_cpu(tmp_path):
    src = ref_make_tiny(str(tmp_path / "src"), quant=None, seed=15,
                        **dict(TINY, layers=1))
    out = str(tmp_path / "out")
    r = subprocess.run(
        [sys.executable, "-m", "exllamav2_tpu_torch.convert", "-i", src,
         "-o", out, "-b", "3.5", "-hb", "6", "-r", "2", "-l", "64",
         "--status_output", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr
    assert '[STATUS]{"stage": "Compiling", "completion": 1.0}' in r.stdout
    qc = _json(out, "config.json")["quantization_config"]
    assert qc["bits"] == 3.5 and qc["head_bits"] == 6
    assert qc["calibration"] == {"rows": 2, "length": 64}
    assert np.isfinite(_port_logits(out)).all()


def test_perplexity_matches_reference(tmp_path):
    rows = np.clip(calibration_rows(ByteTokenizer(), 3, 96), 0, 383)
    ref_model = RefModel.from_dir(TRAINED)
    model = Model.from_dir(TRAINED, device="cpu")
    for kind, batch in (("bf16", 2), ("q4", 1)):
        ref = ref_perplexity(ref_model, rows, cache_kind=kind, batch=batch)
        seen = []
        got = perplexity(model, rows, cache_kind=kind, batch=batch,
                         progress=lambda done, total: seen.append(done))
        assert abs(got - ref) <= PPL_TOL * ref, (kind, got, ref)
        assert seen[-1] == 3
    # the fixture converted on the CPU stays close to its dense perplexity
    out = str(tmp_path / "tt")
    convert_model(TRAINED, out, bits=4.0, head_bits=6, progress=_quiet,
                  device="cpu")
    conv = perplexity(Model.from_dir(out, device="cpu"), rows)
    dense = perplexity(model, rows)
    assert np.isfinite(conv) and conv < 1.5 * dense, (conv, dense)
