"""The port's overlapped tensor-parallel rings (parallel/overlap.py) and TP
decoder layer (parallel/tp_layer.py) against mxq_tpu's same functions on
the 8-virtual-device mesh, against mxq_tpu's single-device oracles
(tests/test_overlap.py) and against the port's unsharded products.

The port's side runs in gloo ranks, 2 (tp 2) and 4 (tp 4), started once
for the module (tests/torch_dist_workers.py), every ring hop a
batch_isend_irecv. Packed weights go through ``llama.quant_linear`` (the
plain versions of K1-K3 on the CPU); on mxq_tpu's side through the
pure-jnp dequant (``packfmt.unpack_dequant``), the same bf16(x) @
dequant(W) as the port's plain GEMV, not interpret-mode Pallas."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxq_tpu import packfmt as jpackfmt
from mxq_tpu.models import llama as jl
from mxq_tpu.parallel import overlap as jov
from mxq_tpu.parallel import sharding as jsh
from mxq_tpu.parallel import tp_layer as jtp
from mxq_tpu_torch import packfmt, weights
from mxq_tpu_torch.models import llama as tl
from mxq_tpu_torch.ops import mxq_matmul as mm
from mxq_tpu_torch.parallel import overlap
from test_overlap import _ref_decode_layer, _ref_prefill_layer
from torch_dist_workers import RING_CASES, Ranks, ring_inputs

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

# the port's ring or layer against mxq_tpu's same one, or a ring against
# the port's unsharded product, over max|y|: the f32 partial sums add up
# in the same order (summation inside a product may differ); measured
# 3.5e-7 to 9.6e-7 against mxq_tpu's (rings, dense layers, every cache),
# 2.6e-7 to 5.7e-7 against the unsharded products
SAME_RING_GATE = 1e-5
# a packed layer against mxq_tpu's: its GEMVs round their inputs to bf16,
# so an f32 ulp apart in the norm or the softmax can move an input by a
# bf16 ulp (measured 4.3e-4 decode, 1.7e-3 prefill; mxq_tpu's own gate
# for these layers against its oracle is 3e-2)
PACKED_LAYER_GATE = 5e-3


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("rings")
    started = {w: Ranks("ring_cases", w, str(root / f"w{w}"), dict(
        cases=[n for n, c in RING_CASES.items() if c[3] == w]))
        for w in (2, 4)}
    done = {}

    def output(name):
        w = RING_CASES[name][3]
        if w not in done:
            done[w] = started[w].results()
        return done[w]

    yield output
    for w in started:
        if w not in done:
            started[w].results()


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _packs(w):
    """(the port's packed linear of an [in, out] numpy weight, the same
    planes as mxq_tpu's PackedMXQLinear: the packers are bit-equal,
    tests/test_torch_packfmt.py)."""
    p = packfmt.quantize_pack(torch.from_numpy(w.T.copy()))
    return p, jpackfmt.PackedMXQLinear(
        **{f: jnp.asarray(weights.tensor_to_numpy(getattr(p, f)))
           for f in packfmt.FIELDS},
        in_features=p.in_features, out_features=p.out_features)


def _jpack(w):
    return _packs(w)[1]


def _jmm(a, p):
    """mxq_tpu's bf16(x) @ dequant(p), pure jnp."""
    return (a.astype(jnp.bfloat16).astype(jnp.float32)
            @ jpackfmt.unpack_dequant(p))


def _port_y(outputs, name):
    """The whole output of a case from the ranks' K-chunks."""
    parts = [o[name] for o in outputs]
    if isinstance(parts[0], tuple):
        return tuple(np.concatenate([p[i] for p in parts],
                                    axis=-1 if i == 0 else 2)
                     for i in range(3))
    return np.concatenate(parts, axis=-1)


@pytest.mark.parametrize("name", ["block", "block_packed", "block_tp4",
                                  "mlp", "mlp_packed"])
def test_tp_rings_match_jax_and_unsharded(ranks, name):
    """tp_block_matmuls and tp_packed_mlp (tp 2; the dense block also at
    tp 4 over 4096 columns) against mxq_tpu's on the virtual mesh and
    against the port's unsharded product, each within SAME_RING_GATE of
    max|y| (mxq_tpu's own gates, dense rtol 1e-4 atol 1e-3 and packed
    2e-2 of max|y|, lie far above what these products differ by)."""
    kind, packed, _, tp = RING_CASES[name]
    c = ring_inputs(name)
    x, w = c["x"], c["w"]
    jmesh = jsh.make_mesh(dp=1, fsdp=1, tp=tp)
    n_ktl = x.shape[-1] // jov.KT_COLS // tp
    jw = {k: _jpack(v) if packed else jnp.asarray(v) for k, v in w.items()}
    jmm = _jmm if packed else (lambda a, b: a @ b)
    if kind == "block":
        want = jax.jit(lambda a, c_, r_: jov.tp_block_matmuls(
            jmesh, a, c_, r_, jmm, n_ktiles_local=n_ktl,
            chunk_cols=x.shape[-1] // tp))(jnp.asarray(x), jw["wc"],
                                           jw["wr"])
    else:
        want = jax.jit(lambda a, g, u, d: jov.tp_packed_mlp(
            jmesh, a, g, u, d, jmm, n_ktiles_local=n_ktl,
            chunk_cols=x.shape[-1] // tp))(jnp.asarray(x), jw["gate"],
                                           jw["up"], jw["down"])
    # the port's unsharded product
    xt = torch.from_numpy(x)
    if packed:
        pw = {k: packfmt.quantize_pack(torch.from_numpy(v.T.copy()))
              for k, v in w.items()}
        lin = functools.partial(tl.quant_linear, cfg=tl.LlamaConfig())
    else:
        pw = {k: torch.from_numpy(v) for k, v in w.items()}
        lin = torch.matmul
    if kind == "block":
        ref = lin(lin(xt, pw["wc"]), pw["wr"])
    else:
        act = torch.nn.functional.silu(lin(xt, pw["gate"])) * lin(
            xt, pw["up"])
        ref = lin(act, pw["down"])
    got = _port_y(ranks(name), name)
    assert got.shape == tuple(ref.shape)
    assert _rel(got, want) <= SAME_RING_GATE
    assert _rel(got, ref.numpy()) <= SAME_RING_GATE


@pytest.mark.parametrize("name", ["decode", "decode_packed", "decode_gqa",
                                  "prefill", "prefill_packed",
                                  "prefill_gqa"])
def test_tp_layers_match_jax(ranks, name):
    """tp_decode_layer and tp_prefill_layer at tp 2 (hidden 2048, 16 heads;
    GQA with 4 kv heads), dense and packed: the output and the
    head-sharded cache against mxq_tpu's same layer on the virtual mesh
    (within SAME_RING_GATE of max|y|), and the output against
    tests/test_overlap.py's single-device oracle within its gates (dense
    rtol/atol 2e-3, packed 3e-2 of max|y| against the dequantized dense
    weights)."""
    kind, packed, _, tp = RING_CASES[name]
    c = ring_inputs(name)
    cfg = jl.LlamaConfig.tiny(**c["cfg"])
    lw, dense = {}, {}
    for k, v in c["w"].items():
        if packed and v.ndim == 2:
            p, lw[k] = _packs(v)
            dense[k] = jnp.asarray(packfmt.unpack_dequant(p).numpy())
        else:
            lw[k] = dense[k] = jnp.asarray(v)
    cache = {k: jnp.asarray(v) for k, v in c["cache"].items()}
    jmesh = jsh.make_mesh(dp=1, fsdp=1, tp=tp)
    jmm = _jmm if packed else (lambda a, b: a @ b)
    x = jnp.asarray(c["x"])
    if kind == "decode":
        pos = jnp.asarray(c["positions"])
        want, wc = jax.jit(lambda *a: jtp.tp_decode_layer(
            jmesh, *a, cfg, jmm))(x, lw, cache, pos)
        oracle, _ = jax.jit(lambda *a: _ref_decode_layer(*a, cfg))(
            x, dense, cache, pos)
    else:
        want, wc = jax.jit(lambda *a: jtp.tp_prefill_layer(
            jmesh, *a, cfg, jmm))(x, lw, cache)
        oracle, _ = jax.jit(lambda *a: _ref_prefill_layer(*a, cfg))(
            x, dense, cache)
    y, ck, cv = _port_y(ranks(name), name)
    assert y.shape == tuple(want.shape) and ck.shape == wc["k"].shape
    gate = PACKED_LAYER_GATE if packed else SAME_RING_GATE
    assert _rel(y, want) <= gate
    assert _rel(ck, wc["k"]) <= gate
    assert _rel(cv, wc["v"]) <= gate
    if packed:
        assert _rel(y, oracle) <= 3e-2
    else:
        np.testing.assert_allclose(y, np.asarray(oracle), rtol=2e-3,
                                   atol=2e-3)


@pytest.mark.parametrize("kind", ["n", "k"])
def test_packed_specs_match_jax(kind):
    """packed_specs names mxq_tpu's split of every field (a JAX
    PartitionSpec is the tuple of its entries)."""
    jp = _jpack(np.zeros((1024, 1024), np.float32))
    want = jov.packed_specs(jp, kind)
    assert overlap.packed_specs(kind) == {
        f: tuple(getattr(want, f)) for f in packfmt.FIELDS}


def test_packed_ktile_slices_are_additive():
    """slice_ktiles views hold the planes of mxq_tpu's slices, and
    the partial products over disjoint k-tiles add up to the whole
    product within 1e-6 of max|y| (f32 sums in another order)."""
    rng = np.random.RandomState(3)
    w = rng.randn(1024, 2048).astype(np.float32)          # [O, K]
    x = torch.from_numpy(rng.randn(2, 2048).astype(np.float32))
    p, jp = _packs(w.T)
    full = mm.gemv_plain(x, p)
    parts = []
    for t in range(p.nbp // packfmt.NB_TILE):
        pt = overlap.slice_ktiles(p, t, 1)
        jt = jov.slice_ktiles(jp, t, 1)
        for f in packfmt.FIELDS:
            got, want = getattr(pt, f), np.asarray(getattr(jt, f))
            if got.dtype == torch.bfloat16:
                got = got.view(torch.int16)
                want = want.view(np.int16)
            assert np.array_equal(got.numpy(), want), (t, f)
        assert pt.w2.is_contiguous() and pt.in_features == overlap.KT_COLS
        parts.append(mm.gemv_plain(x[:, t * 1024:(t + 1) * 1024], pt))
    assert _rel(sum(parts), full) <= 1e-6


@pytest.mark.parametrize("tp", [2, 4])
def test_llama2_7b_widths(tp):
    """At llama2_7b's intermediate size: a column shard of gate/up (11008
    outputs padded to 11264, so 5632 or 2816 a rank) is re-padded to the
    format (N a multiple of 1024, contiguous) and its product equals
    mxq_tpu's product of the same shard (which takes the width, within
    1e-6 of max|y|); a row shard of down_proj (176 meta rows: 88 or 44 a
    rank, no whole k-tiles) is refused, as mxq_tpu's dequant refuses it.
    Cut to 1024 on the other side of each weight."""
    rng = np.random.RandomState(4)
    wg = rng.randn(11008, 1024).astype(np.float32) * 0.02   # [O, K]
    x = rng.randn(2, 1024).astype(np.float32)
    p = packfmt.quantize_pack(torch.from_numpy(wg))
    jp = _jpack(wg.T)
    n_l = p.n_padded // tp
    for r in range(tp):
        local = overlap.shard_weight(p, "n", r, tp)
        assert local.n_padded % packfmt.N_LANE == 0 and all(
            getattr(local, f).is_contiguous() for f in packfmt.FIELDS)
        assert local.out_features == n_l
        j_shard = jov.localize(jpackfmt.PackedMXQLinear(
            **{f: getattr(jp, f)[:, r * n_l:(r + 1) * n_l]
               for f in packfmt.FIELDS},
            in_features=jp.in_features, out_features=jp.out_features))
        want = _jmm(jnp.asarray(x), j_shard)
        got = mm.gemv_plain(torch.from_numpy(x), local)
        assert got.shape == want.shape
        assert _rel(got, want) <= 1e-6
    wd = rng.randn(1024, 11008).astype(np.float32) * 0.02
    pd = packfmt.quantize_pack(torch.from_numpy(wd))
    with pytest.raises(ValueError, match="whole k-tiles"):
        overlap.shard_weight(pd, "k", 0, tp)
    jd = _jpack(wd.T)
    rows = jd.nbp // tp
    j_shard = jpackfmt.PackedMXQLinear(
        w2=jd.w2[:rows * 3], w4=jd.w4[:rows * 2], meta2=jd.meta2[:rows],
        qscale=jd.qscale[:rows], qmin=jd.qmin[:rows], smeta4=jd.smeta4,
        in_features=rows * 64, out_features=jd.out_features)
    with pytest.raises(TypeError, match="reshape"):
        jpackfmt.unpack_dequant(j_shard)
