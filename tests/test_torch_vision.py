"""The port's vision models (mxq_tpu_torch/vision/) against mxq_tpu's on the
CPU: the counterparts of tests/test_vision.py's 18 tests, each on the same
params carried across the numpy bridge, plus the window helpers, the
synthetic set, the numpy bridge's round trip of every params tree and
``cli prune-vision``.

Tolerances: f32 logits within 1e-5 of max|logit|; pruned weights equal
entry for entry (the masks come from the same metric, computed in f32 on
both sides); PTQ fake-quant weights within 1e-6 of max|w| (the port's
``scheme`` against ``mxq_tpu``'s). JAX runs jitted (eagerly, Swin's
forward alone takes ~9 s on this CPU)."""

import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxq_tpu import cli as jcli
from mxq_tpu.vision import convnext as jconvnext
from mxq_tpu.vision import eval as jeval
from mxq_tpu.vision import mixer as jmixer
from mxq_tpu.vision import prune_vision as jprune
from mxq_tpu.vision import swin as jswin
from mxq_tpu.vision import vit as jvit
from mxq_tpu_torch import cli, weights
from mxq_tpu_torch.vision import convnext, mixer, prune_vision, swin, vit
from mxq_tpu_torch.vision import eval as veval
from torch_port_helpers import port_params, rel, to_numpy_tree

LOGIT_TOL = 1e-5
QUANT_TOL = 1e-6
# (port module, mxq_tpu module, config kwargs) of each model's tiny preset
MODELS = {"vit": (vit, jvit, {}), "deit": (vit, jvit, {"distilled": True}),
          "convnext": (convnext, jconvnext, {}), "swin": (swin, jswin, {}),
          "mixer": (mixer, jmixer, {})}
_CFG = {vit: "ViTConfig", convnext: "ConvNeXtConfig", swin: "SwinConfig",
        mixer: "MixerConfig"}


def _cfgs(mod, jmod, **kw):
    name = _CFG[mod]
    return getattr(mod, name).tiny(**kw), getattr(jmod, name).tiny(**kw)


def _images(n=2, seed=1, size=32):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                        (n, size, size, 3)))


def _setup(model, **kw):
    """(port cfg, jax cfg, port params, jax params, images) of a model's
    tiny preset from mxq_tpu's init at PRNGKey(0)."""
    mod, jmod, base = MODELS[model]
    cfg, jcfg = _cfgs(mod, jmod, **{**base, **kw})
    jp = jmod.init_params(jcfg, jax.random.PRNGKey(0))
    return cfg, jcfg, port_params(jp), jp, _images()


def _jfwd(jmod, jp, imgs, jcfg):
    return np.asarray(jax.jit(lambda p, x: jmod.forward(p, x, jcfg))(
        jp, jnp.asarray(imgs)))


def _forward_matches(model, cfg, jcfg, params, jp, imgs):
    mod, jmod, _ = MODELS[model]
    out = mod.forward(params, imgs, cfg)
    ref = _jfwd(jmod, jp, imgs, jcfg)
    assert out.shape == ref.shape
    assert torch.isfinite(out).all()
    assert rel(out, ref) <= LOGIT_TOL, rel(out, ref)
    return out, ref


def _same_weights(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    np.testing.assert_array_equal(got.numpy() == 0, want == 0)
    np.testing.assert_array_equal(got.numpy(), want)


# ---- ViT (tests/test_vision.py:13-51) ----


def test_vit_forward():
    cfg, jcfg, params, jp, imgs = _setup("vit")
    out, _ = _forward_matches("vit", cfg, jcfg, params, jp, imgs)
    assert out.shape == (2, 10)


def test_prune_vit_wanda():
    cfg, jcfg, params, jp, _ = _setup("vit")
    imgs = _images(4)
    pruned = prune_vision.prune_vit(params, cfg, imgs, sparsity=0.5)
    jpruned = jprune.prune_vit(jp, jcfg, jnp.asarray(imgs), sparsity=0.5)
    for name in vit.BLOCK_LINEARS:
        _same_weights(pruned["blocks"][name], jpruned["blocks"][name])
    s = prune_vision.check_sparsity(pruned)
    assert abs(s - 0.5) < 0.05
    assert s == jprune.check_sparsity(jpruned)
    _forward_matches("vit", cfg, jcfg, pruned, jpruned, imgs)


def test_prune_vit_nm():
    cfg, jcfg, params, jp, imgs = _setup("vit")
    pruned = prune_vision.prune_vit(params, cfg, imgs, method="magnitude",
                                    n=2, m=4)
    jpruned = jprune.prune_vit(jp, jcfg, jnp.asarray(imgs),
                               method="magnitude", n=2, m=4)
    _same_weights(pruned["blocks"]["qkv"], jpruned["blocks"]["qkv"])
    w = pruned["blocks"]["qkv"][0].numpy()
    nz = (w.reshape(-1, 4, w.shape[-1]) != 0).sum(1)
    assert (nz <= 2).all()


def _jax_ptq_stack(stack, jcfg):
    """mxq_tpu's PTQ fake-quant of each [in, out] layer, jitted."""
    from mxq_tpu import scheme as jscheme
    fq = jax.jit(lambda w: jscheme.mxq_fake_quant_ptq(w.T, jcfg.scheme).T)
    return np.stack([np.asarray(fq(w)) for w in stack])


def test_quantize_vit():
    cfg, jcfg, params, jp, _ = _setup("vit")
    q = prune_vision.quantize_vit(params, cfg)
    for name in vit.BLOCK_LINEARS:
        want = _jax_ptq_stack(jp["blocks"][name], jcfg)
        assert rel(q["blocks"][name], want) <= QUANT_TOL
    w0 = params["blocks"]["fc1"]
    wq = q["blocks"]["fc1"]
    assert not torch.allclose(w0, wq)
    assert (w0 - wq).abs().max() < 0.5


# ---- ConvNeXt (tests/test_vision.py:54-106) ----


def test_convnext_forward():
    cfg, jcfg, params, jp, imgs = _setup("convnext")
    out, _ = _forward_matches("convnext", cfg, jcfg, params, jp, imgs)
    assert out.shape == (2, 10)


def _convnext_pruned(method, **kw):
    cfg, jcfg, params, jp, imgs = _setup("convnext")
    pruned = prune_vision.prune_convnext(params, cfg, imgs, method=method,
                                         **kw)
    jpruned = jprune.prune_convnext(jp, jcfg, jnp.asarray(imgs),
                                    method=method, **kw)
    for st, jst in zip(pruned["stages"], jpruned["stages"]):
        for name in convnext.BLOCK_LINEARS:
            _same_weights(st["blocks"][name], jst["blocks"][name])
    return cfg, jcfg, pruned, jpruned, imgs


def test_convnext_prune_wanda_sparsity():
    cfg, jcfg, pruned, jpruned, imgs = _convnext_pruned("wanda",
                                                        sparsity=0.5)
    s = prune_vision.check_sparsity_convnext(pruned)
    assert abs(s - 0.5) < 0.05, s
    assert s == jprune.check_sparsity_convnext(jpruned)
    _forward_matches("convnext", cfg, jcfg, pruned, jpruned, imgs)


def test_convnext_prune_wanda_differs_from_magnitude():
    _, _, pw, _, _ = _convnext_pruned("wanda", sparsity=0.5)
    _, _, pm, _, _ = _convnext_pruned("magnitude", sparsity=0.5)
    w1 = pw["stages"][0]["blocks"]["pwconv1"]
    w2 = pm["stages"][0]["blocks"]["pwconv1"]
    assert ((w1 == 0) != (w2 == 0)).float().mean() > 0.01


def test_convnext_prune_nm_structured():
    _, _, pruned, _, _ = _convnext_pruned("magnitude", n=2, m=4)
    w = pruned["stages"][1]["blocks"]["pwconv2"][0].numpy()
    nz = (w.reshape(-1, 4, w.shape[-1]) != 0).sum(1)
    assert (nz <= 2).all()


def test_convnext_quantize():
    cfg, jcfg, params, jp, imgs = _setup("convnext")
    q = prune_vision.quantize_convnext(params, cfg)
    for st, jst in zip(q["stages"], jp["stages"]):
        for name in convnext.BLOCK_LINEARS:
            want = _jax_ptq_stack(jst["blocks"][name], jcfg)
            assert rel(st["blocks"][name], want) <= QUANT_TOL
    ref = convnext.forward(params, imgs, cfg)
    out = convnext.forward(q, imgs, cfg)
    corr = np.corrcoef(ref.numpy().ravel(), out.numpy().ravel())[0, 1]
    assert corr > 0.95, corr


# ---- DeiT and Mixer (tests/test_vision.py:109-158) ----


def test_deit_forward_and_prune():
    cfg, jcfg, params, jp, imgs = _setup("deit")
    out, _ = _forward_matches("deit", cfg, jcfg, params, jp, imgs)
    assert out.shape == (2, 10)
    pruned = prune_vision.prune_vit(params, cfg, imgs, sparsity=0.5)
    jpruned = jprune.prune_vit(jp, jcfg, jnp.asarray(imgs), sparsity=0.5)
    for name in vit.BLOCK_LINEARS:
        _same_weights(pruned["blocks"][name], jpruned["blocks"][name])
    s = prune_vision.check_sparsity(pruned)
    assert abs(s - 0.5) < 0.05, s
    _forward_matches("deit", cfg, jcfg, pruned, jpruned, imgs)


def test_deit_heads_both_contribute():
    cfg, jcfg, params, jp, imgs = _setup("deit")
    ref, _ = _forward_matches("deit", cfg, jcfg, params, jp, imgs)
    p2 = dict(params, head_dist=params["head_dist"] * 0.0)
    jp2 = dict(jp, head_dist=jp["head_dist"] * 0.0)
    out, _ = _forward_matches("deit", cfg, jcfg, p2, jp2, imgs)
    assert (ref - out).abs().max() > 1e-6


def test_mixer_forward():
    cfg, jcfg, params, jp, imgs = _setup("mixer")
    out, _ = _forward_matches("mixer", cfg, jcfg, params, jp, imgs)
    assert out.shape == (2, 10)


def test_mixer_quantized_close():
    cfg, jcfg, params, jp, imgs = _setup("mixer")
    qcfg, jqcfg = _cfgs(mixer, jmixer, w_bits=2)
    ref = mixer.forward(params, imgs, cfg)
    out, _ = _forward_matches("mixer", qcfg, jqcfg, params, jp, imgs)
    corr = np.corrcoef(ref.numpy().ravel(), out.numpy().ravel())[0, 1]
    assert corr > 0.8, corr
    assert (ref - out).abs().max() > 1e-6


# ---- Swin (tests/test_vision.py:161-203) ----


def test_swin_forward():
    cfg, jcfg, params, jp, imgs = _setup("swin")
    out, _ = _forward_matches("swin", cfg, jcfg, params, jp, imgs)
    assert out.shape == (2, 10)


def test_swin_shifted_windows_change_output(monkeypatch):
    """SW-MSA couples neighbouring windows: with every block's shift forced
    to 0 the logits change (and equal mxq_tpu's with the same patch)."""
    cfg, jcfg = _cfgs(swin, jswin, depths=(2,), num_heads=(2,),
                      image_size=32, window_size=4)
    jp = jswin.init_params(jcfg, jax.random.PRNGKey(0))
    params, imgs = port_params(jp), _images(1)
    ref, _ = _forward_matches("swin", cfg, jcfg, params, jp, imgs)
    for mod in (swin, jswin):
        orig = mod.block
        monkeypatch.setattr(mod, "block", lambda x, p, c, res, nh, shift,
                            ri, mask, orig=orig: orig(x, p, c, res, nh, 0,
                                                      ri, None))
    out, _ = _forward_matches("swin", cfg, jcfg, params, jp, imgs)
    assert (ref - out).abs().max() > 1e-6


def test_swin_window_partition_roundtrip():
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (2, 8, 8, 16)))
    w = swin.window_partition(torch.from_numpy(x.copy()), 4)
    np.testing.assert_array_equal(w.numpy(), np.asarray(
        jswin.window_partition(jnp.asarray(x), 4)))
    back = swin.window_reverse(w, 4, 8, 8)
    np.testing.assert_array_equal(back.numpy(), x)


def test_swin_quantized_close():
    cfg, jcfg, params, jp, imgs = _setup("swin", embed_dim=64)
    qcfg, jqcfg = _cfgs(swin, jswin, embed_dim=64, w_bits=2)
    ref = swin.forward(params, imgs, cfg)
    out, _ = _forward_matches("swin", qcfg, jqcfg, params, jp, imgs)
    corr = np.corrcoef(ref.numpy().ravel(), out.numpy().ravel())[0, 1]
    assert corr > 0.8, corr
    assert (ref - out).abs().max() > 1e-6


@pytest.mark.parametrize("res,ws,shift", [(8, 4, 2), (14, 7, 3),
                                          (56, 7, 3)])
def test_swin_window_tables_equal(res, ws, shift):
    np.testing.assert_array_equal(swin.rel_pos_index(ws),
                                  jswin.rel_pos_index(ws))
    np.testing.assert_array_equal(swin.shift_attn_mask(res, ws, shift),
                                  jswin.shift_attn_mask(res, ws, shift))


# ---- eval (tests/test_vision.py:206-213) ----


def test_vision_eval_topk():
    cfg, jcfg, params, jp, _ = _setup("vit")
    batches = list(veval.synthetic_batches(cfg.num_classes, 32, n=32))
    stats = veval.evaluate(vit.forward, params, cfg, batches)
    assert stats == jeval.evaluate(jvit.forward, jp, jcfg, batches)
    assert stats["n"] == 32
    assert 0.0 <= stats["acc1"] <= stats["acc5"] <= 1.0


def test_synthetic_batches_equal_reference():
    ours = list(veval.synthetic_batches(10, 16, n=40, batch=16, seed=3))
    theirs = list(jeval.synthetic_batches(10, 16, n=40, batch=16, seed=3))
    assert [len(b[1]) for b in ours] == [16, 16, 8]
    for (a, la), (b, lb) in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)


def test_imagenet_absent_gives_none(tmp_path):
    assert veval.imagenet_val_batches(224) is None
    assert veval.imagenet_val_batches(224, path=str(tmp_path / "no")) \
        is None


# ---- the numpy bridge (lists of stages) and the published presets ----


@pytest.mark.parametrize("model", sorted(MODELS))
def test_params_roundtrip_numpy(model):
    mod, jmod, base = MODELS[model]
    cfg, jcfg = _cfgs(mod, jmod, **base)
    params = mod.init_params(cfg, 0, device="cpu")
    tree = weights.params_to_numpy(params)
    back = weights.params_from_numpy(tree, "cpu")
    flat = jax.tree_util.tree_leaves_with_path(tree)
    assert flat and all(isinstance(v, np.ndarray) for _, v in flat)
    theirs = jax.tree_util.tree_structure(to_numpy_tree(
        jmod.init_params(jcfg, jax.random.PRNGKey(0))))
    assert jax.tree_util.tree_structure(tree) == theirs
    for (path, a), b in zip(flat, jax.tree_util.tree_leaves(
            weights.params_to_numpy(back))):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    if "stages" in params:
        moved = weights.params_to(back, "cpu")
        assert isinstance(moved["stages"], list)
        assert len(moved["stages"]) == len(params["stages"])


@pytest.mark.parametrize("model", sorted(MODELS))
def test_configs_equal_reference(model):
    mod, jmod, base = MODELS[model]
    name = _CFG[mod]

    def fields(c):
        return {k: v for k, v in dataclasses.asdict(c).items()
                if k != "scheme"}

    assert fields(getattr(mod, name)()) == fields(getattr(jmod, name)())
    assert fields(getattr(mod, name).tiny(**base)) \
        == fields(getattr(jmod, name).tiny(**base))
    assert mod.BLOCK_LINEARS == jmod.BLOCK_LINEARS


# ---- cli prune-vision ----


def _with_reference_init(monkeypatch, seed_key):
    """The port's init_params patched to return mxq_tpu's params (drawn
    with JAX's PRNG from the same seed), carried across."""
    for mod, jmod in ((vit, jvit), (convnext, jconvnext), (swin, jswin),
                      (mixer, jmixer)):
        jname = _CFG[mod]

        def init(cfg, seed=0, dtype=torch.float32, device="cuda",
                 jmod=jmod, jname=jname):
            kw = {k: v for k, v in dataclasses.asdict(cfg).items()
                  if k != "scheme"}
            jcfg = getattr(jmod, jname)(**kw)
            return weights.params_from_numpy(to_numpy_tree(
                jmod.init_params(jcfg, seed_key(seed))), device)

        monkeypatch.setattr(mod, "init_params", init)


@pytest.mark.parametrize("argv", [
    ["--model", "vit"], ["--model", "deit", "--prune_metric", "magnitude"],
    ["--model", "convnext", "--prune_n", "2", "--prune_m", "4",
     "--prune_metric", "magnitude"],
    ["--model", "mixer"], ["--model", "swin", "--nsamples", "8"]],
    ids=lambda a: "-".join(a[1::2]))
def test_cli_prune_vision_prints_reference_lines(argv, monkeypatch):
    _with_reference_init(monkeypatch, jax.random.PRNGKey)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jcli.main(["prune-vision"] + argv)
    want = buf.getvalue()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = cli.main(["prune-vision", "--device", "cpu"] + argv)
    assert buf.getvalue() == want
    assert want.startswith("dense: acc1=")
    assert ("pruned" in res) == (argv[1] in ("vit", "deit", "convnext"))
