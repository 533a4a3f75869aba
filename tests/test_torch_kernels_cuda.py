"""K1-K4 on the card against their plain PyTorch versions at small shapes.
Needs a CUDA device and nvcc (marker ``cuda``); skips elsewhere. Run on the
H100 with ``python -m pytest -m cuda tests/test_torch_kernels_cuda.py``;
``chip_smoke.py`` holds the same kernels at llama2_7b's shapes."""

import math

import pytest
import torch

from mxq_tpu_torch import packfmt
from mxq_tpu_torch.ops import attn_int8 as a8
from mxq_tpu_torch.ops import mxq_matmul as mm

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _pack(gen, o, k):
    w = torch.randn((o, k), generator=gen, device="cuda") / math.sqrt(k)
    return packfmt.quantize_pack(w)


@pytest.mark.parametrize("b", [1, 2, 8, 13, 128])
@pytest.mark.parametrize("o,k", [(320, 1088), (1024, 4096)])
def test_gemv_kernels_match_plain(gen, b, o, k):
    p = _pack(gen, o, k)
    x = torch.randn((b, k), generator=gen, device="cuda").to(torch.bfloat16)
    fn = mm.gemv_single if b == 1 else mm.gemv_batched
    y = fn(x, p)
    ref = mm.gemv_plain(x, p)
    torch.cuda.synchronize()
    assert y.shape == (b, o)
    assert float((y - ref).abs().max() / ref.abs().max()) <= 1e-4


@pytest.mark.parametrize("o,k", [(320, 1088), (1024, 4096)])
def test_dequant_kernel_bit_equal(gen, o, k):
    p = _pack(gen, o, k)
    wd2, wd4 = mm.dequant_planes(p)
    r2, r4 = mm.dequant_planes_plain(p)
    torch.cuda.synchronize()
    assert torch.equal(wd2.view(torch.int16), r2.view(torch.int16))
    assert torch.equal(wd4.view(torch.int16), r4.view(torch.int16))


@pytest.mark.parametrize("hq,hkv,d", [(4, 2, 64), (8, 8, 128), (16, 2, 128)])
def test_attention_kernel_matches_plain(gen, hq, hkv, d):
    L, B, S = 2, 3, 96
    cat = dict(generator=gen, device="cuda")
    kc = torch.randint(-127, 128, (L, B, hkv, S, d), dtype=torch.int8, **cat)
    vc = torch.randint(-127, 128, (L, B, hkv, S, d), dtype=torch.int8, **cat)
    ks = (torch.rand((L, B, hkv, S), **cat) * 0.02 + 1e-3).to(torch.bfloat16)
    vs = (torch.rand((L, B, hkv, S), **cat) * 0.02 + 1e-3).to(torch.bfloat16)
    q = torch.randn((B, hq, d), **cat).to(torch.bfloat16)
    kcur = torch.randint(-127, 128, (B, hkv, 1, d), dtype=torch.int8, **cat)
    vcur = torch.randint(-127, 128, (B, hkv, 1, d), dtype=torch.int8, **cat)
    kscur = (torch.rand((B, hkv, 1), **cat) * 0.02 + 1e-3).to(torch.bfloat16)
    vscur = (torch.rand((B, hkv, 1), **cat) * 0.02 + 1e-3).to(torch.bfloat16)
    pos = torch.tensor([0, 50, S - 1], dtype=torch.int32, device="cuda")
    kc1, vc1 = kc.clone(), vc.clone()
    ctx, _, _ = a8.int8_decode_attention_fused_write(
        q, kc1, ks, vc1, vs, kcur, kscur, vcur, vscur, 1, pos)
    ref, _, _ = a8.int8_decode_attention_fused_write_plain(
        q, kc, ks, vc, vs, kcur, kscur, vcur, vscur, 1, pos)
    torch.cuda.synchronize()
    assert float((ctx - ref).abs().max() / ref.abs().max()) <= 1e-3
    assert torch.equal(kc1, kc) and torch.equal(vc1, vc)
