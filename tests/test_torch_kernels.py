"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips (with the reason) where no GPU is present,
as on CPU-only machines; `python3 chip_smoke.py` runs the same checks at the
Llama-2-7B shapes. On a card: `python -m pytest tests/test_torch_kernels.py`.
"""

import pytest
import torch

from exllamav2_tpu_torch.ops import decode_attn as A
from exllamav2_tpu_torch.ops import qmm as Q
from exllamav2_tpu_torch.ops.dequant import precompute_scales_linear
from exllamav2_tpu_torch.utils.testing import (
    random_gptq_linear, random_quant_linear)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("m", [1, 3, 4, 8, 16, 17, 32])
@pytest.mark.parametrize("kind", ["exl2_2", "exl2_3", "exl2_4_prescaled",
                                  "exl2_5", "exl2_6", "exl2_8", "gptq_4"])
def test_qmm_kernel_matches_plain(dev, kind, m):
    gen = torch.Generator(device=dev)
    gen.manual_seed(m)
    k, n = 768, 384
    if kind == "gptq_4":
        lin = random_gptq_linear(gen, k, n, group_rows=64, device=dev)
    else:
        bits = int(kind.split("_")[1])
        lin = random_quant_linear(gen, k, n, bits=bits, device=dev)
        if kind.endswith("prescaled"):
            lin = precompute_scales_linear(lin)
    seg = lin.segments[0]
    x = torch.randn((m, seg.rows_pad), generator=gen, device=dev).to(
        torch.bfloat16)
    before = Q.LAUNCHES["qmm"]
    got = Q.fused_segment_matmul(x, seg)
    assert Q.LAUNCHES["qmm"] == before + 1
    ref = Q.qmm_plain(x, seg)
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.parametrize("hq,hkv,d,past,cap,win", [
    (8, 8, 128, 0, 0.0, 0), (8, 2, 128, 100, 0.0, 0),
    (8, 2, 128, 255, 20.0, 0), (16, 4, 128, 300, 0.0, 64),
    (8, 1, 64, 77, 0.0, 0), (4, 2, 256, 130, 0.0, 0)])
def test_decode_attention_kernel_matches_plain(dev, hq, hkv, d, past, cap,
                                               win):
    gen = torch.Generator(device=dev)
    gen.manual_seed(past)
    shape = (2, 2, hkv, 512, d)
    k = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn((2, hq, d), generator=gen, device=dev).to(
        torch.bfloat16)
    limit = 512
    got = A.decode_attention(q, k, v, 1, past, limit, 0.09, cap, win)
    ref = A.decode_attention_plain(q, k, v, 1, past, limit, 0.09, cap, win)
    assert (got - ref).abs().max() <= 1e-4 * v.float().abs().max()
