"""The reference's frozen EXL2 decoding against the port's plain dequant,
on the same packed words (the reference itself imports nothing of the
port; only this test does)."""

import torch

from bench_port import weights
from bench_port.reference import common as reference


def test_frozen_dequant_matches_the_port():
    from exllamav2_tpu_torch.ops.dequant import dequant_linear
    cfg = {"vocab_size": 512, "hidden_size": 256, "intermediate_size": 512,
           "num_hidden_layers": 1, "num_attention_heads": 4,
           "num_key_value_heads": 2, "rope_theta": 1e6, "rms_norm_eps": 1e-5}
    packed = weights.draw_packed(cfg, 2 ** 33 + 5, "cpu")
    model = weights.program_model(cfg, packed, 512, "cpu")
    lw = model.weights.layers[0]
    for name, lin in (("l0.q", lw.attn.q), ("l0.down", lw.mlp.down),
                      ("head", model.weights.head)):
        ref = reference.dequant(packed.linears[name])
        port = dequant_linear(lin, dtype=torch.float32)
        assert ref.shape == port.shape
        assert torch.equal(ref, port), name
        # unit gain: E[w^2] * k near the drawn gain
        k = ref.shape[0]
        gain = weights.GAIN.get(name.rsplit(".", 1)[-1], 1.0)
        assert 0.5 < float((ref * ref).mean() * k) / gain ** 2 < 2.0
