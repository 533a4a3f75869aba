"""The port's Llama forward against mxq_tpu's on the tiny preset, from the
same packed weights, without a cache, through the 512-token prefill path,
and with the stacked int8 cache (prefill, then three decode steps), for MHA
and GQA.

Tolerances, as rel = max|diff| / max|logit|: every packed product rounds
its activations to bf16 (as the JAX kernels do), so an f32-rounding
difference upstream (softmax and einsum sum in another order) flips single
bf16 roundings, each a 2^-8 relative step of one activation;
``test_logit_gap_is_bf16_rounding_of_activations`` shows this at layer 0.
Measured without a cache over eight seeds (kv_heads 4 and 2, seeds 0-3):
1.0e-3 to 3.0e-3; with the int8 cache 2e-3 to 4e-3; on the 512-token
prefill, whose two GEMMs also round their outputs to bf16, 9.5e-3,
1.05e-2 and 8.6e-3 over seeds 3-5. The gates are 1e-2 and 3e-2; the
unpacked f32 model is held to 1e-5, and greedy tokens are held equal in
test_torch_engine.py."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mxq_tpu.models import llama as jl
from mxq_tpu.serving import kvcache as jkv
from mxq_tpu_torch.models import llama as tl
from mxq_tpu_torch.serving import kvcache as tkv
from torch_port_helpers import bits, port_params, rel, to_torch

TOL = 1e-2
TOL_PREFILL = 3e-2


def _models(kv_heads: int, seed: int = 0, packed: bool = True):
    jcfg = jl.LlamaConfig.tiny(num_key_value_heads=kv_heads)
    tcfg = tl.LlamaConfig.tiny(num_key_value_heads=kv_heads)
    params = jl.init_params(jcfg, jax.random.PRNGKey(seed))
    if packed:
        params = jl.quantize_params_packed(params, jcfg)
    return jcfg, tcfg, params, port_params(params)


def test_config_presets_match():
    for name in ("tiny", "llama2_7b", "llama2_13b", "llama2_70b"):
        a = dataclasses.asdict(getattr(jl.LlamaConfig, name)())
        b = dataclasses.asdict(getattr(tl.LlamaConfig, name)())
        assert a == b, name


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_packed_forward_no_cache(kv_heads):
    jcfg, tcfg, jp, tp = _models(kv_heads)
    ids = np.random.default_rng(1).integers(0, 512, (2, 9)).astype(np.int32)
    lj, _ = jl.forward(jp, jnp.asarray(ids), jcfg)
    lt, caches = tl.forward(tp, ids, tcfg, device="cpu")
    assert caches is None and lt.shape == (2, 9, 512)
    assert rel(lt, lj) <= TOL


def test_packed_forward_prefill_path_512_tokens():
    """512 tokens route every packed linear through the prefill path
    (K3's plain version + bf16 GEMMs) on both sides."""
    jcfg, tcfg, jp, tp = _models(4, seed=3)
    ids = np.random.default_rng(2).integers(0, 512, (1, 512)).astype(
        np.int32)
    lj, _ = jl.forward(jp, jnp.asarray(ids), jcfg)
    lt, _ = tl.forward(tp, ids, tcfg, device="cpu")
    assert rel(lt, lj) <= TOL_PREFILL
    agree = (lt.argmax(-1).numpy() == np.asarray(lj).argmax(-1)).mean()
    assert agree >= 0.95


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_packed_forward_int8_cache_prefill_then_decode(kv_heads):
    jcfg, tcfg, jp, tp = _models(kv_heads, seed=1)
    b, t0, s, steps = 2, 6, 16, 3
    ids = np.random.default_rng(4).integers(0, 512, (b, t0 + steps)).astype(
        np.int32)
    jc = jkv.init_quant_cache(2, b, s, kv_heads, jcfg.head_dim)
    tc = tkv.init_quant_cache(2, b, s, kv_heads, tcfg.head_dim,
                              device="cpu")
    lj, jc = jl.forward(jp, jnp.asarray(ids[:, :t0]), jcfg, caches=jc,
                        cache_pos=0)
    lt, tc2 = tl.forward(tp, ids[:, :t0], tcfg, caches=tc, cache_pos=0,
                         device="cpu")
    assert tc2 is tc                              # updated in place
    assert rel(lt, lj) <= TOL
    for i in range(steps):
        pos = t0 + i
        lj, jc = jl.forward(jp, jnp.asarray(ids[:, pos:pos + 1]), jcfg,
                            caches=jc, cache_pos=pos)
        lt, _ = tl.forward(tp, ids[:, pos:pos + 1], tcfg, caches=tc,
                           cache_pos=pos, device="cpu")
        assert rel(lt, lj) <= TOL, i
    # the written rows hold the same scales (codes may differ by one where
    # K/V values sit on a rounding boundary; their dequantized values agree)
    filled = t0 + steps
    for name in ("k_scale", "v_scale"):
        a = tc[name][..., :filled].float()
        bj = to_torch(jc[name])[..., :filled].float()
        assert rel(a, bj) <= 1e-2, name
    assert not bits(tc["k_scale"][..., filled:]).any()


def test_logit_gap_is_bf16_rounding_of_activations(monkeypatch):
    """Layer 0's attention on the same input, recording what each side's
    o_proj receives: the f32 contexts differ only by summation order
    (rel <= 1e-5), and the o_proj outputs' difference is, to 1e-5 of
    max|o|, the one made by the elements whose bf16 rounding came out
    differently (2 of 4608 at seed 0, giving 4.3e-4)."""
    from mxq_tpu_torch import packfmt as tpf
    jcfg, tcfg, jp, tp = _models(4, seed=0)
    ids = np.random.default_rng(1).integers(0, 512, (2, 9)).astype(np.int32)
    x = jp["embed_tokens"][jnp.asarray(ids)]
    h = jl.rms_norm(x, jp["layers"]["input_layernorm"][0], jcfg.rms_norm_eps)
    pos = jnp.broadcast_to(jnp.arange(9)[None], (2, 9))
    jcos, jsin = jl.rope_tables(jcfg, pos)
    jlayer = {k: jax.tree_util.tree_map(lambda a: a[0], v)
              for k, v in jp["layers"].items()}
    tlayer = tl.layer_view(tp, 0)
    tcos, tsin = tl.rope_tables(tcfg, torch.arange(9)[None].expand(2, 9))

    seen = {}
    for name, mod in (("jax", jl), ("port", tl)):
        inner = mod.quant_linear

        def record(xx, w, cfg, *rest, _inner=inner, _name=name):
            y = _inner(xx, w, cfg, *rest)
            seen.setdefault(_name, []).append((xx, y))
            return y
        monkeypatch.setattr(mod, "quant_linear", record)
    jl.attention(h, jlayer, jcfg, jcos, jsin, jl.causal_mask(9))
    tl.attention(to_torch(h), tlayer, tcfg, tcos, tsin, tl.causal_mask(9))
    (ctx_j, o_j), (ctx_t, o_t) = seen["jax"][1], seen["port"][1]
    ctx_j, o_j = to_torch(ctx_j).reshape(18, -1), to_torch(o_j).reshape(18, -1)
    ctx_t, o_t = ctx_t.reshape(18, -1), o_t.reshape(18, -1)
    assert rel(ctx_t, ctx_j) <= 1e-5
    flips = ctx_t.to(torch.bfloat16).float() - ctx_j.to(torch.bfloat16).float()
    from_flips = flips @ tpf.unpack_dequant(tlayer["o_proj"])
    assert float((o_t - o_j - from_flips).abs().max()
                 / o_j.abs().max()) <= 1e-5


def test_dense_forward_matches():
    jcfg, tcfg, jp, tp = _models(2, seed=2, packed=False)
    ids = np.random.default_rng(5).integers(0, 512, (2, 7)).astype(np.int32)
    lj, _ = jl.forward(jp, jnp.asarray(ids), jcfg)
    lt, _ = tl.forward(tp, ids, tcfg, device="cpu")
    assert rel(lt, lj) <= 1e-5


def test_port_init_and_pack_roundtrip_shapes():
    cfg = tl.LlamaConfig.tiny(num_hidden_layers=1)
    params = tl.init_params(cfg, seed=0, device="cpu")
    again = tl.init_params(cfg, seed=0, device="cpu")
    assert torch.equal(params["layers"]["q_proj"], again["layers"]["q_proj"])
    packed = tl.quantize_params_packed(params, cfg, device="cpu")
    layers = packed["layers"]
    assert set(layers) == {"qkv_proj", "o_proj", "gate_up_proj", "down_proj",
                           "input_layernorm", "post_attention_layernorm"}
    assert layers["qkv_proj"].out_features == 3 * 256
    assert layers["gate_up_proj"].w2.shape[0] == 1
    logits, _ = tl.forward(packed, np.zeros((1, 4), np.int32), cfg,
                           device="cpu")
    assert logits.shape == (1, 4, 512) and bool(torch.isfinite(logits).all())


def test_unported_features_raise():
    """The int8 activation prefill (prefill_act_bits=8, K5) and weight
    fake-quant (w_bits < 32) run; sharded calibration (ptq --shard) is
    still not ported and raises."""
    from mxq_tpu_torch import cli
    cfg = tl.LlamaConfig.tiny(num_hidden_layers=1)
    params = tl.init_params(cfg, seed=0, device="cpu")
    packed = tl.quantize_params_packed(params, cfg, device="cpu")
    ids = np.zeros((1, 512), np.int32)
    logits, _ = tl.forward(packed, ids,
                           dataclasses.replace(cfg, prefill_act_bits=8),
                           device="cpu")
    assert logits.shape == (1, 512, 512)
    assert bool(torch.isfinite(logits).all())
    fp, _ = tl.forward(params, ids[:, :4], cfg, device="cpu")
    w2, _ = tl.forward(params, ids[:, :4], dataclasses.replace(cfg, w_bits=2),
                       device="cpu")
    assert bool(torch.isfinite(w2).all()) and not torch.equal(w2, fp)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(["ptq", "--device", "cpu", "--shard", "1,2,4"])


def test_packed_forward_a8_prefill_matches_jax():
    """512 tokens with prefill_act_bits=8 route every packed linear through
    the int8 path (K5's plain version + int8 GEMMs) on both sides. One
    linear on the same input agrees to 5e-3 (test_torch_mxq_matmul.py);
    through the model, the activations differ by the bf16 gap above, and
    where a per-token int8 code flips, it moves an activation by
    max|x|/127, ~2^-7 of the row's largest value against a bf16 flip's
    2^-8 of the element. Measured over seeds 3-5: port vs JAX 3.3e-2 to
    3.5e-2 of max|logit|, argmax agreement 0.947-0.957, while the A8 path
    of either side differs from its own bf16-plane path by 4.7e-2 to
    5.9e-2. Gates 5e-2 and 0.9."""
    jcfg, tcfg, jp, tp = _models(4, seed=3)
    jcfg = dataclasses.replace(jcfg, prefill_act_bits=8)
    tcfg8 = dataclasses.replace(tcfg, prefill_act_bits=8)
    ids = np.random.default_rng(2).integers(0, 512, (1, 512)).astype(
        np.int32)
    lj, _ = jl.forward(jp, jnp.asarray(ids), jcfg)
    lt, _ = tl.forward(tp, ids, tcfg8, device="cpu")
    assert rel(lt, lj) <= 5e-2
    agree = (lt.argmax(-1).numpy() == np.asarray(lj).argmax(-1)).mean()
    assert agree >= 0.9
    # the int8 quantization error against the port's bf16-plane prefill
    lb, _ = tl.forward(tp, ids, tcfg, device="cpu")
    assert rel(lt, lb) <= 0.1


def test_packed_lm_head_forward_matches_jax():
    """A uniform-4b lm_head packed by JAX, carried into the port: the
    forward's logits go through u4_matmul (K7's plain version) on the port
    side and JAX's interpret-mode kernel on the other."""
    from mxq_tpu.ops import uniform4 as ju4
    from mxq_tpu_torch.ops import uniform4 as tu4
    jcfg, tcfg, jp, _ = _models(2, seed=5)
    jp = dict(jp, lm_head=ju4.quantize_pack_u4(jp["lm_head"].T))
    tp = port_params(jp)
    assert isinstance(tp["lm_head"], tu4.PackedU4Linear)
    ids = np.random.default_rng(6).integers(0, 512, (2, 9)).astype(np.int32)
    lj, _ = jl.forward(jp, jnp.asarray(ids), jcfg)
    lt, _ = tl.forward(tp, ids, tcfg, device="cpu")
    assert rel(lt, lj) <= TOL


def _random_cache(quant: bool, b: int, s: int, kv_heads: int, seed: int):
    """The same random cache state for both sides: (jax caches, port
    caches)."""
    rng = np.random.default_rng(seed)
    bf = ml_dtypes.bfloat16
    if quant:
        shape = (2, b, kv_heads, s, 64)
        a = {"k_codes": rng.integers(-127, 128, shape).astype(np.int8),
             "v_codes": rng.integers(-127, 128, shape).astype(np.int8),
             "k_scale": (rng.random(shape[:-1]) * 0.02 + 1e-3).astype(bf),
             "v_scale": (rng.random(shape[:-1]) * 0.02 + 1e-3).astype(bf)}
    else:
        shape = (2, b, s, kv_heads, 64)
        a = {k: rng.standard_normal(shape).astype(bf) for k in ("k", "v")}
    return ({k: jnp.asarray(v) for k, v in a.items()},
            {k: to_torch(v) for k, v in a.items()})


@pytest.mark.parametrize("quant", [True, False])
def test_verify_step_matches_jax_forward_multipos(quant):
    """decode_slots with T=5 tokens per slot (the speculative verify: rows
    positions[b] + t written, each query attending the rows up to its own;
    K4a's plain version per query on the int8 cache) against JAX's
    _forward_multipos from the same cache state. Gate 1e-2: the bf16
    activation gap above."""
    from mxq_tpu.serving import engine as jeng
    jcfg, tcfg, jp, tp = _models(2, seed=1)
    b, s, t = 3, 32, 5
    jc, tc = _random_cache(quant, b, s, 2, seed=8)
    ids = np.random.default_rng(9).integers(0, 512, (b, t)).astype(np.int32)
    pos = np.array([3, 10, 27], np.int32)
    lj, jc = jeng._forward_multipos(jp, jnp.asarray(ids), jcfg, jc,
                                    jnp.asarray(pos))
    lt = tl.decode_slots(tp, torch.from_numpy(ids), tcfg, tc,
                         torch.from_numpy(pos))
    assert lt.shape == (b, t, 512)
    assert rel(lt, lj) <= TOL
    assert (lt.argmax(-1).numpy() == np.asarray(lj).argmax(-1)).mean() >= 0.9
    for name in tc:
        assert rel(tc[name], to_torch(jc[name])) <= 1e-2, name


def test_verify_step_equals_sequential_decode():
    """One T=5 verify step against 5 sequential T=1 steps (K4 with its
    scale commit) fed the same tokens from the same int8 state: the same
    logits up to the summation order of 15-row and 3-row products and the
    bf16 roundings it flips (1.3e-3 of max|logit| at seed 2), the same
    argmax, the same cache rows."""
    _, tcfg, _, tp = _models(2, seed=2)
    b, s, t = 3, 32, 5
    _, c1 = _random_cache(True, b, s, 2, seed=10)
    c2 = {k: v.clone() for k, v in c1.items()}
    ids = torch.from_numpy(np.random.default_rng(11).integers(
        0, 512, (b, t)).astype(np.int32))
    pos = torch.tensor([0, 9, 26], dtype=torch.int32)
    verify = tl.decode_slots(tp, ids, tcfg, c1, pos)
    steps = torch.cat([tl.decode_slots(tp, ids[:, i:i + 1], tcfg, c2,
                                       pos + i) for i in range(t)], dim=1)
    assert rel(verify, steps) <= 1e-2
    assert torch.equal(verify.argmax(-1), steps.argmax(-1))
    for name in c1:
        assert rel(c1[name], c2[name]) <= 1e-2, name


def test_entry_points_default_to_cuda():
    """Without a CUDA device, an entry point called without a device
    raises instead of running on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = tl.LlamaConfig.tiny(num_hidden_layers=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tl.init_params(cfg)
    params = tl.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tl.forward(params, np.zeros((1, 2), np.int32), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tl.quantize_params_packed(params, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tkv.init_quant_cache(1, 1, 8, 1, 64)
