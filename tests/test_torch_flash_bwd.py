"""K13-bwd, flash attention's backward, on the CPU, where its wrapper and
``FlashAttention`` take the plain versions, against ``mxq_tpu`` and the
upstream Pallas kernels it calls, from numpy seeds:

- the plain backward against ``jax.vjp`` of upstream ``flash_attention``
  run in interpret mode (its custom VJP: the dK/dV and dQ
  ``pallas_call``s), with JAX repeating k and v to the query heads;
- ``FlashAttention`` against ``jax.vjp`` of ``mxq_tpu``'s einsum
  attention, at float32 and bfloat16;
- the plain forward's row log-sum-exp, and its context bit for bit;
- the slice as a whole: one KD step of the tiny preset through
  ``qat.train.loss_fn`` against ``mxq_tpu``'s under ``jax.value_and_grad``
  with upstream flash attention and its VJP, and the same step with
  ``remat``;
- on the CPU nothing launches, and under autograd the route is
  ``FlashAttention``, never SDPA.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import flash_attention

from mxq_tpu.models import llama as jl
from mxq_tpu.qat import train as jtrain
from mxq_tpu_torch.models import llama as tl
from mxq_tpu_torch.ops import attn_bf16 as ab
from mxq_tpu_torch.qat import train as ttrain
from torch_port_helpers import port_params, rel, to_torch


def _inputs(seed, t, hq, hkv, d, b=1):
    """q, do [B, T, Hq, D] and k, v [B, T, Hkv, D], f32 normals."""
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, t, hq, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, t, hkv, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v, do


def _repeat(k, v, g):
    return jnp.repeat(k, g, axis=2), jnp.repeat(v, g, axis=2)


@pytest.fixture
def routes(monkeypatch):
    """Counts of the calls of the K13 with-lse forward and of the K13-bwd
    wrapper (each still runs)."""
    calls = {"forward": 0, "backward": 0}
    for name, key in (("flash_attention_forward", "forward"),
                      ("flash_attention_backward", "backward")):
        fn = getattr(ab, name)

        def counted(*a, _fn=fn, _key=key):
            calls[_key] += 1
            return _fn(*a)
        monkeypatch.setattr(ab, name, counted)
    return calls


def _bwd_against_upstream(seed, hkv, d, hq=2, t=256):
    """flash_attention_bwd_plain on the plain forward's o and lse against
    ``jax.vjp`` of upstream flash_attention (causal, sm_scale 1/sqrt(D),
    default 128-row blocks) in interpret mode, at B=1, T=256 (two blocks:
    the grid crosses the diagonal), f32, k and v repeated by JAX (Hkv 1:
    JAX's autograd sums the repeats, the plain version sums the group):
    each gradient within 1e-5 of its max (measured <= 6.9e-7 at D = 64:
    f32 sums in other orders, and upstream's exp(s - m) / l against
    exp(s - lse))."""
    q, k, v, do = _inputs(seed, t, hq, hkv, d)

    def upstream(q, k, v):
        k, v = _repeat(k, v, hq // hkv)
        return flash_attention(
            q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
            v.transpose(0, 2, 1, 3), causal=True,
            sm_scale=float(1.0 / np.sqrt(d))).transpose(0, 2, 1, 3)

    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(upstream, q, k, v)
        want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (to_torch(x) for x in (q, k, v, do))
    o, lse = ab.flash_attention_forward_plain(tq, tk, tv)
    assert rel(o, out) <= 1e-5
    got = ab.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo)
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == torch.float32 and tuple(g.shape) == x.shape
        assert rel(g, w) <= 1e-5


@pytest.mark.parametrize("hkv", [2, 1])
def test_bwd_plain_matches_upstream_flash_vjp(hkv):
    """2 query heads of 64 (see :func:`_bwd_against_upstream`)."""
    _bwd_against_upstream(hkv, hkv, 64)


@pytest.mark.parametrize("hkv,d", [(2, 80), (2, 96), (1, 100), (1, 256)])
def test_bwd_plain_matches_upstream_flash_vjp_head_dims(hkv, d):
    """The same at head_dims the kernels run at their 128 template
    (upstream takes every D <= 128) and at 256 (Gemma-2B's, the 256
    template's own width)."""
    _bwd_against_upstream(d, hkv, d)


def _einsum_attention(q, k, v):
    """``mxq_tpu.models.llama.attention``'s einsum path (:377-380 and
    :397-406) on q [B, T, Hq, D], k, v [B, T, Hkv, D]: k, v repeated to
    the query heads, f32 scores over sqrt(D) plus the causal mask, f32
    softmax, probabilities in v's type, the context in q's type."""
    t, hq, d = q.shape[1], q.shape[2], q.shape[3]
    k, v = _repeat(k, v, hq // k.shape[2])
    qf = q.transpose(0, 2, 1, 3).astype(jnp.float32)
    kf = k.transpose(0, 2, 1, 3).astype(jnp.float32)
    vf = v.transpose(0, 2, 1, 3)
    scores = jnp.einsum("bhtd,bhsd->bhts", qf, kf) / np.sqrt(d)
    scores = scores + jl.causal_mask(t)
    probs = jax.nn.softmax(scores, axis=-1).astype(vf.dtype)
    return jnp.einsum("bhts,bhsd->bhtd", probs, vf).transpose(0, 2, 1, 3) \
        .astype(q.dtype)


@pytest.mark.parametrize("dtype,gate", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
def test_flash_function_matches_jax_grad_of_einsum_attention(routes, dtype,
                                                             gate):
    """``FlashAttention`` (its plain forward and backward on the CPU), 2
    sequences of 200 tokens (not a multiple of any block), 4 query heads
    of 64 over 2 kv heads, against ``jax.vjp`` of mxq_tpu's einsum
    attention on the same inputs: the context and each gradient within
    ``gate`` of its max. float32 1e-5 (f32 sums in other orders; measured
    <= 7.9e-7); bfloat16 2e-2, K13's bf16 gate (measured <= 5.4e-3): both
    sides round the probabilities to bf16, but JAX's autograd of the
    einsum rounds its own intermediates (the bf16 product's cotangents),
    where the flash backward rounds P and dS as upstream's VJP does."""
    q, k, v, do = _inputs(3, 200, 4, 2, 64, b=2)
    jdt = jnp.dtype(dtype)
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jdt) for x in (q, k, v, do))
    out, vjp = jax.vjp(_einsum_attention, jq, jk, jv)
    want = vjp(jdo)
    tq, tk, tv = (to_torch(x).requires_grad_() for x in (jq, jk, jv))
    ctx = ab.FlashAttention.apply(tq, tk, tv)
    got = torch.autograd.grad(ctx, (tq, tk, tv), to_torch(jdo))
    assert routes == {"forward": 1, "backward": 1}
    assert ctx.dtype == tq.dtype and rel(ctx.detach(), out) <= gate
    for g, w, x in zip(got, want, (tq, tk, tv)):
        assert g.dtype == x.dtype and g.shape == x.shape
        assert rel(g, w) <= gate


def test_forward_plain_lse_and_context():
    """flash_attention_forward_plain's lse against ``logsumexp`` of the
    masked scaled scores, computed here in float64, within 4e-6 (f32 lse
    of up to about 9: four ulps of a value in [8, 16); measured 6.7e-7),
    with k, v 9 rows longer than q (never read); its
    context is flash_prefill_attention_plain's bit for bit, at f32 and
    bf16."""
    q, k, v, _ = _inputs(4, 96, 4, 2, 64, b=2)
    kl, vl = (np.concatenate([x, x[:, :9]], axis=1) for x in (k, v))
    for dtype in (torch.float32, torch.bfloat16):
        tq, tk, tv = (to_torch(x).to(dtype) for x in (q, kl, vl))
        ctx, lse = ab.flash_attention_forward_plain(tq, tk, tv)
        assert torch.equal(ctx, ab.flash_prefill_attention_plain(tq, tk, tv))
        qd = tq.double().transpose(1, 2)
        kd = tk[:, :96].double().repeat_interleave(2, dim=2).transpose(1, 2)
        s = qd @ kd.transpose(-1, -2) / 8.0
        s = s.masked_fill(torch.ones(96, 96, dtype=torch.bool).triu(1),
                          -torch.inf)
        assert lse.dtype == torch.float32 and lse.shape == (2, 4, 96)
        assert float((lse.double() - torch.logsumexp(s, -1)).abs().max()) \
            <= 4e-6


IDS = np.random.default_rng(0).integers(0, 512, (2, 128)).astype(np.int32)


def _full(cfg):
    return dataclasses.replace(cfg, w_bits=32, a_bits=32, kv_bits=32)


@pytest.fixture(scope="module")
def jparams():
    """JAX's student (seed 0) and teacher (seed 1) init of the tiny
    preset, f32."""
    cfg = jl.LlamaConfig.tiny()
    return (jl.init_params(cfg, jax.random.PRNGKey(0)),
            jl.init_params(cfg, jax.random.PRNGKey(1)))


def _port_step(jparams, remat):
    """The port's KD loss and its gradients by leaf (tiny, w_bits 2,
    ``attn_impl="flash"``)."""
    tcfg = tl.LlamaConfig.tiny(w_bits=2, attn_impl="flash")
    params = port_params(jparams[0])
    for t in ttrain.leaves(params).values():
        t.requires_grad_(True)
    loss = ttrain.loss_fn(params, port_params(jparams[1]),
                          {"input_ids": torch.from_numpy(IDS)}, tcfg,
                          _full(tcfg), ttrain.TrainConfig(remat=remat))
    loss.backward()
    return loss.detach(), {n: t.grad for n, t in
                           ttrain.leaves(params).items()}


def test_kd_step_matches_jax_upstream_flash_vjp(jparams, routes):
    """One KD step of the tiny preset (w_bits 2, ``attn_impl="flash"``, no
    remat, 2 x 128 tokens): the port's loss_fn and backward (the student
    through FlashAttention, the teacher through K13's plain version)
    against jitted ``jax.value_and_grad`` of mxq_tpu's loss_fn in
    interpret mode, where both models run upstream flash_attention and
    the student's gradients its VJP. The loss within 1e-5 relative
    (measured 1.5e-7), each leaf's gradient within 1e-5 of its max
    (measured <= 2.3e-6). ``remat=True`` cannot run on the JAX side here:
    interpret mode's ordered IO callback is refused under
    ``jax.checkpoint``."""
    jcfg = jl.LlamaConfig.tiny(w_bits=2, attn_impl="flash")
    grad = jax.jit(jax.value_and_grad(jtrain.loss_fn),
                   static_argnums=(3, 4, 5))
    with pltpu.force_tpu_interpret_mode():
        jloss, jg = grad(jparams[0], jparams[1],
                         {"input_ids": jnp.asarray(IDS)}, jcfg, _full(jcfg),
                         jtrain.TrainConfig(remat=False))
    loss, grads = _port_step(jparams, remat=False)
    layers = jl.LlamaConfig.tiny().num_hidden_layers
    # the student's layers through FlashAttention, once each way
    assert routes == {"forward": layers, "backward": layers}
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = ttrain.leaves(jax.tree_util.tree_map(np.asarray, jg))
    assert set(grads) == set(want)
    for n, g in grads.items():
        assert rel(g, want[n]) <= 1e-5, n


def test_kd_step_with_remat_equals_without(jparams, routes):
    """The same port step with ``remat=True`` (each decoder layer
    recomputed in the backward through
    ``torch.utils.checkpoint(use_reentrant=False)``) gives the loss and
    every gradient of ``remat=False`` bit for bit; the recomputation runs
    the student's K13 forward again, so a layer takes it twice and K13-bwd
    once."""
    base = _port_step(jparams, remat=False)
    layers = jl.LlamaConfig.tiny().num_hidden_layers
    assert routes == {"forward": layers, "backward": layers}
    loss, grads = _port_step(jparams, remat=True)
    assert routes == {"forward": 3 * layers, "backward": 2 * layers}
    assert torch.equal(loss, base[0])
    for n, g in grads.items():
        assert torch.equal(g, base[1][n]), n


def test_autograd_route_is_flash_attention_and_launches_nothing(
        monkeypatch, routes):
    """``_attend_step`` under autograd with ``attn_impl="flash"`` on the
    CPU goes through FlashAttention (its plain forward and backward), never
    through SDPA, and no kernel wrapper counts a launch; outside autograd
    it stays K13's plain version, bit for bit the same context."""
    def no_sdpa(*a, **k):
        raise AssertionError("SDPA called")
    monkeypatch.setattr(torch.nn.functional, "scaled_dot_product_attention",
                        no_sdpa)
    before = [f.launches for f in ab.KERNELS.values()]
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(), attn_impl="flash")
    q, k, v, do = (to_torch(x) for x in _inputs(5, 128, 4, 2, 64))
    with torch.no_grad():
        plain = tl._attend_step(cfg, None, None, None, torch.float32, 0, q,
                                k, v)
    assert routes == {"forward": 0, "backward": 0}
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ctx = tl._attend_step(cfg, None, None, None, torch.float32, 0, *leaves)
    ctx.backward(do)
    assert routes == {"forward": 1, "backward": 1}
    assert torch.equal(ctx.detach(), plain)
    assert all(x.grad is not None for x in leaves)
    assert [f.launches for f in ab.KERNELS.values()] == before
    assert "K13-bwd" in ab.KERNELS


def test_port_calls_no_library_attention():
    """No module of the port calls PyTorch's SDPA: flash attention's
    forward and backward are K13 and K13-bwd (only chip_smoke.py times
    SDPA, as a yardstick)."""
    import pathlib

    import mxq_tpu_torch
    root = pathlib.Path(mxq_tpu_torch.__file__).parent
    calls = [str(f.relative_to(root)) for f in sorted(root.rglob("*.py"))
             if "scaled_dot_product_attention" in f.read_text()]
    assert calls == []
