"""QAT of the port (the train branches of models/llama, qat/train,
qat/data, qat/loop, utils/metrics, utils/profiling, cli train and
generate-data) against mxq_tpu's on the tiny preset: the same
numpy-seeded inputs, and JAX's init_params carried across with
weights.params_from_numpy. JAX runs op by op (``jax.disable_jit()``)
where it computes the fake-quant forward: jitted, XLA may fuse a division
the port rounds as JAX's eager run does (ROADMAP.md queue 3)."""

import dataclasses
import json
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mxq_tpu import cli as jcli
from mxq_tpu.models import llama as jl
from mxq_tpu.qat import data as jdata
from mxq_tpu.qat import loop as jloop
from mxq_tpu.qat import train as jtrain
from mxq_tpu.utils import profiling as jprof
from mxq_tpu_torch import cli
from mxq_tpu_torch.models import llama as tl
from mxq_tpu_torch.qat import data as tdata
from mxq_tpu_torch.qat import loop as tloop
from mxq_tpu_torch.qat import train as ttrain
from mxq_tpu_torch.utils import profiling as tprof
from mxq_tpu_torch.utils.metrics import MetricsWriter
from torch_port_helpers import port_params, rel

IDS = np.random.default_rng(0).integers(0, 512, (2, 32)).astype(np.int32)


def _cfgs(**bits):
    return jl.LlamaConfig.tiny(**bits), tl.LlamaConfig.tiny(**bits)


def _full(cfg):
    return dataclasses.replace(cfg, w_bits=32, a_bits=32, kv_bits=32)


@pytest.fixture(scope="module")
def jparams():
    """JAX's student (seed 0) and teacher (seed 1) init, f32."""
    cfg = jl.LlamaConfig.tiny()
    return (jl.init_params(cfg, jax.random.PRNGKey(0)),
            jl.init_params(cfg, jax.random.PRNGKey(1)))


@pytest.fixture
def no_tensorboard(monkeypatch):
    """``torch.utils.tensorboard`` fails to import (importing it takes
    ~10 s on a CPU host): MetricsWriter keeps only its JSONL backend."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _leaf_copy(jax_params) -> dict:
    """The port's CPU params from JAX's, every tensor a leaf that requires
    grad."""
    params = port_params(jax_params)
    for t in ttrain.leaves(params).values():
        t.requires_grad_(True)
    return params


def _np_leaves(tree) -> dict:
    return ttrain.leaves(jax.tree_util.tree_map(np.asarray, tree))


def test_kd_and_ce_loss_match_jax():
    """kd_loss_fn (scaled, masked) and the shifted cross_entropy_loss
    (ignore_index -100) within 1e-6 of JAX's, relative; the KD loss of
    equal logits is 0."""
    rng = np.random.default_rng(3)
    s, t = (rng.standard_normal((2, 9, 64)).astype(np.float32) * 3
            for _ in range(2))
    labels = rng.integers(0, 64, (2, 9))
    labels[0, 4] = labels[1, 7] = -100
    mask = labels != -100
    for scale in (1.0, 2.5):
        want = float(jtrain.kd_loss_fn(jnp.asarray(s), jnp.asarray(t),
                                       jnp.asarray(mask), scale))
        got = float(ttrain.kd_loss_fn(torch.from_numpy(s), torch.from_numpy(t),
                                      torch.from_numpy(mask), scale))
        assert abs(got - want) <= 1e-6 * abs(want)
    want = float(jl.cross_entropy_loss(jnp.asarray(s), jnp.asarray(labels)))
    got = float(tl.cross_entropy_loss(torch.from_numpy(s),
                                      torch.from_numpy(labels)))
    assert abs(got - want) <= 1e-6 * abs(want)
    same = torch.from_numpy(s)
    assert abs(float(ttrain.kd_loss_fn(same, same, torch.ones(2, 9)))) < 1e-6


# name -> (bits, KD, JAX op by op). The cases beside w2_kd hold the port
# against jitted JAX: op by op, each new path's first call compiles its
# primitives for 5-20 s on the CPU.
GRAD_CASES = {"w2_kd": (dict(w_bits=2), True, True),
              "w2_ce": (dict(w_bits=2), False, False),
              "w1_ce": (dict(w_bits=1), False, False),
              "a8_kv8_kd": (dict(w_bits=2, a_bits=8, kv_bits=8), True, False)}


def _port_loss_grads(params, teacher, cfg, tc):
    p = _leaf_copy(params)
    loss = ttrain.loss_fn(p, teacher, {"input_ids": torch.from_numpy(IDS)},
                          cfg, _full(cfg), tc)
    loss.backward()
    return loss.detach(), {n: t.grad for n, t in ttrain.leaves(p).items()}


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_loss_gradients_match_jax_grad(jparams, name):
    """loss_fn and its gradients (the straight-through estimators of
    ``train=True``) against jax.value_and_grad of JAX's: the loss within
    1e-6 relative (measured <= 3.7e-7), each leaf's gradient within 1e-5 of
    its max|g| (measured 2.3e-6 for w2_kd op by op; 1.9e-6, 1.6e-6 and
    1.9e-6 for w2_ce, w1_ce and a8_kv8_kd against jitted JAX).
    ``remat`` changes neither the loss nor
    any gradient, bit for bit."""
    bits, kd, eager = GRAD_CASES[name]
    jcfg, tcfg = _cfgs(**bits)
    js, jt = jparams
    grad = jax.value_and_grad(jtrain.loss_fn)
    if not eager:
        grad = jax.jit(grad, static_argnums=(3, 4, 5))
    with jax.disable_jit(eager):
        jloss, jg = grad(js, jt, {"input_ids": jnp.asarray(IDS)}, jcfg,
                         _full(jcfg), jtrain.TrainConfig(use_kd=kd,
                                                         remat=False))
    teacher = port_params(jt)
    loss, grads = _port_loss_grads(js, teacher, tcfg,
                                   ttrain.TrainConfig(use_kd=kd, remat=False))
    assert abs(float(loss) - float(jloss)) <= 1e-6 * abs(float(jloss))
    want = _np_leaves(jg)
    assert set(grads) == set(want)
    for n, g in grads.items():
        assert rel(g, want[n]) <= 1e-5, n
    loss_r, grads_r = _port_loss_grads(
        js, teacher, tcfg, ttrain.TrainConfig(use_kd=kd, remat=True))
    assert torch.equal(loss_r, loss)
    for n, g in grads.items():
        assert torch.equal(grads_r[n], g), n


def test_train_and_remat_keep_the_forward(jparams):
    """``train`` and ``remat`` leave the logits bit for bit (w_bits 2: the
    straight-through forward is the fake-quant itself); at full precision
    ``train`` leaves the gradients too."""
    _, tcfg = _cfgs(w_bits=2)
    params = _leaf_copy(jparams[0])
    ids = torch.from_numpy(IDS)
    base = tl.forward(params, ids, tcfg, device="cpu")[0]
    for train, remat in ((True, False), (True, True), (False, True)):
        got = tl.forward(params, ids, tcfg, device="cpu", train=train,
                         remat=remat)[0]
        assert torch.equal(got, base), (train, remat)
    full = _full(tcfg)
    grads = []
    for train in (False, True):
        p = _leaf_copy(jparams[0])
        tl.cross_entropy_loss(tl.forward(p, ids, full, device="cpu",
                                         train=train)[0], ids).backward()
        grads.append([t.grad for t in ttrain.leaves(p).values()])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_optimizer_matches_optax(weight_decay):
    """make_optimizer against optax's chain (global-norm clip, then adamw
    on the warmup-cosine schedule: warmup 2, total 5) on one sequence of 5
    gradients, three of them scaled past the clip: the parameters within
    1e-6 of JAX's (relative, per leaf), the returned norm that of the
    unclipped gradients; the first warmup update changes nothing."""
    rng = np.random.default_rng(5)
    shapes = {"a": (16, 8), "b": {"c": (5,)}}

    def draw(scale):
        return jax.tree_util.tree_map(
            lambda s: (rng.standard_normal(s) * scale).astype(np.float32),
            shapes, is_leaf=lambda s: isinstance(s, tuple))

    params = draw(1.0)
    grads = [draw(s) for s in (3.0, 0.05, 2.0, 0.02, 1.5)]
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=5,
              weight_decay=weight_decay)
    jopt = jtrain.make_optimizer(jtrain.TrainConfig(**kw))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = jopt.init(jp)
    tp = _leaf_copy(params)
    named = ttrain.leaves(tp)
    first = {n: t.detach().clone() for n, t in named.items()}
    opt = ttrain.make_optimizer(ttrain.TrainConfig(**kw), tp)
    clipped = 0
    for k, g in enumerate(grads):
        upd, state = jopt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                 state, jp)
        jp = optax.apply_updates(jp, upd)
        for n, a in ttrain.leaves(g).items():
            named[n].grad = torch.from_numpy(a.copy())
        norm = opt.step()
        want_norm = float(optax.global_norm(g))
        clipped += want_norm >= 1.0
        assert abs(float(norm) - want_norm) <= 1e-6 * want_norm
        if k == 0:
            assert all(torch.equal(t.detach(), first[n])
                       for n, t in named.items())
        want = _np_leaves(jp)
        for n, t in named.items():
            assert rel(t.detach(), want[n]) <= 1e-6, (k, n)
    assert clipped == 3 and opt.count == 5


def test_lr_multiplier_is_optax_schedule():
    """The learning rate of each update against optax's schedules, with
    and without warmup."""
    for warmup in (0, 3):
        tc = ttrain.TrainConfig(learning_rate=1e-3, warmup_steps=warmup,
                                total_steps=10)
        sched = (optax.warmup_cosine_decay_schedule(0.0, 1e-3, warmup, 10)
                 if warmup else optax.cosine_decay_schedule(1e-3, 10))
        mult = ttrain.lr_multiplier(tc)
        for count in range(12):
            assert abs(1e-3 * mult(count) - float(sched(count))) <= 1e-9
    with pytest.raises(ValueError):
        ttrain.lr_multiplier(ttrain.TrainConfig(warmup_steps=5,
                                                total_steps=5))


def _batch(seed):
    ids = np.random.default_rng(seed).integers(0, 512, (2, 32)).astype(
        np.int32)
    return ids


def test_train_steps_match_jax(jparams):
    """Three make_train_step steps (KD, w_bits 2, remat, the default
    learning rate 2e-5) against JAX's run op by op: the loss, the grad_norm
    and every parameter within 1e-5 of JAX's, relative. (AdamW's first
    steps move a weight by about lr * g / (|g| + 1e-8), so a gradient near
    1e-8 turns its summation-order difference into a step difference: at
    lr 1e-3 the embedding sat 5.5e-5 off; at 2e-5 the worst leaf 1.3e-6,
    3.9e-6 and 6.7e-6 after each step.)"""
    jcfg, tcfg = _cfgs(w_bits=2)
    kw = dict(total_steps=10, use_kd=True, remat=True)
    js, jt = jparams
    jopt = jtrain.make_optimizer(jtrain.TrainConfig(**kw))
    jstep = jtrain.make_train_step(jcfg, jtrain.TrainConfig(**kw), jopt)
    state = jopt.init(js)
    params, teacher = _leaf_copy(js), port_params(jt)
    opt = ttrain.make_optimizer(ttrain.TrainConfig(**kw), params)
    step = ttrain.make_train_step(tcfg, ttrain.TrainConfig(**kw), opt)
    for k in range(3):
        ids = _batch(10 + k)
        with jax.disable_jit():
            js, state, jm = jstep(js, jt, state,
                                  {"input_ids": jnp.asarray(ids)})
        m = step(params, teacher, {"input_ids": torch.from_numpy(ids)})
        for key in ("loss", "grad_norm"):
            assert abs(float(m[key]) - float(jm[key])) <= 1e-5 * abs(
                float(jm[key])), (k, key)
        want = _np_leaves(js)
        for n, t in ttrain.leaves(params).items():
            assert rel(t.detach(), want[n]) <= 1e-5, (k, n)


def test_sequence_classification_matches_jax(jparams):
    """The score head on each row's last non-pad token (pad id 0, rows
    padded on the right, one row all pads) within 1e-5 of JAX's."""
    jcfg, tcfg = _cfgs()
    head = np.random.default_rng(6).standard_normal((256, 3)).astype(
        np.float32) * 0.05
    jp = dict(jparams[0], score=jnp.asarray(head))
    ids = np.random.default_rng(7).integers(1, 512, (3, 12)).astype(np.int32)
    ids[0, 9:] = 0
    ids[2, :] = 0
    want = np.asarray(jl.sequence_classification_forward(
        jp, jnp.asarray(ids), jcfg, num_labels=3))
    got = tl.sequence_classification_forward(
        port_params(jp), ids, tcfg, num_labels=3, device="cpu")
    assert got.shape == (3, 3)
    assert rel(got, want) <= 1e-5


def test_data_helpers_equal_jax(tmp_path):
    """chunked_dataset, train_valid_split and the batch order equal JAX's;
    the shards write_jsonl_chunk writes and merge_chunks joins equal JAX's
    byte for byte."""
    streams = [np.arange(100), np.arange(57) + 7, np.arange(300) % 29]
    data = tdata.chunked_dataset(streams, block_size=16)
    want = jdata.chunked_dataset(streams, block_size=16)
    assert data.dtype == want.dtype and np.array_equal(data, want)
    for got, want in zip(tdata.train_valid_split(list(data), 5),
                         jdata.train_valid_split(list(data), 5)):
        assert len(got) == len(want) and all(
            np.array_equal(a, b) for a, b in zip(got, want))
    got = list(tdata.batches(data, 3, seed=4, epochs=2, device="cpu"))
    ref = list(jdata.batches(data, 3, seed=4, epochs=2))
    assert len(got) == len(ref) == 2 * (len(data) // 3)
    for g, r in zip(got, ref):
        assert np.array_equal(g["input_ids"].numpy(), np.asarray(
            r["input_ids"]))
        assert np.array_equal(g["labels"].numpy(), np.asarray(r["labels"]))
    for side, mod in (("port", tdata), ("jax", jdata)):
        d = tmp_path / side
        d.mkdir()
        for i in range(3):
            mod.write_jsonl_chunk(str(d / f"gen.chunk.{i:02d}.jsonl"),
                                  data[i * 4:(i + 1) * 4])
        (d / "notes.txt").write_text("skipped")
        assert mod.merge_chunks(str(d), str(d / "all_gen.jsonl")) == 12
    for name in ("gen.chunk.01.jsonl", "all_gen.jsonl"):
        assert (tmp_path / "port" / name).read_bytes() == (
            tmp_path / "jax" / name).read_bytes()
    assert tdata.read_jsonl_texts(str(tmp_path / "port" / "all_gen.jsonl")) \
        == jdata.read_jsonl_texts(str(tmp_path / "jax" / "all_gen.jsonl"))


def test_synthesize_corpus_greedy_equals_jax(jparams):
    """All greedy (the prefix as long as the sequence): the port's tokens,
    made through the cached forward's f32-cache decode step, equal JAX's
    and the argmax of a no-cache recompute of each prefix."""
    jcfg, tcfg = _cfgs()
    seeds = np.asarray([3, 5, 400], np.int32)
    want = jdata.synthesize_corpus(jparams[0], jcfg, seeds, length=16,
                                   greedy_prefix_min=16,
                                   greedy_prefix_max=16)
    params = port_params(jparams[0])
    got = tdata.synthesize_corpus(params, tcfg, seeds, length=16,
                                  greedy_prefix_min=16, greedy_prefix_max=16,
                                  device="cpu")
    assert got.dtype == np.int32 and np.array_equal(got, want)
    logits = tl.forward(params, got, tcfg, device="cpu")[0]
    assert np.array_equal(got[:, 1:], logits[:, :-1].argmax(-1).numpy())


def test_synthesize_corpus_sampling(jparams):
    """With sampling: the same seed gives the same tokens, another seed
    others; every token lies in the vocabulary, each row starts with its
    seed token, and the greedy prefix (positions 1 .. length-1 of
    ``greedy_lengths``, drawn first from the seed's generator) is the
    recompute's argmax."""
    _, tcfg = _cfgs()
    params = port_params(jparams[0])
    seeds = np.asarray([3, 5, 400, 11], np.int32)
    a, b, c = (tdata.synthesize_corpus(params, tcfg, seeds, length=12,
                                       seed=s, device="cpu")
               for s in (0, 0, 1))
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a.min() >= 0 and a.max() < tcfg.vocab_size
    assert np.array_equal(a[:, 0], seeds)
    glen = tdata.greedy_lengths(4, 3, 5, torch.Generator().manual_seed(0))
    argmax = tl.forward(params, a, tcfg, device="cpu")[0].argmax(-1).numpy()
    for row, g in enumerate(glen.tolist()):
        assert 3 <= g <= 5
        assert np.array_equal(a[row, 1:g], argmax[row, :g - 1])


def _loop_run(jparams, out, max_steps, **kw):
    """run_training of a copy of the JAX student (w_bits 2, KD), 16 batches
    of the same seeded order, a fixed schedule (warmup 2, total 8)."""
    _, tcfg = _cfgs(w_bits=2)
    data = tdata.chunked_dataset([IDS.reshape(-1)] * 16, block_size=16)
    logs = []
    res = tloop.run_training(
        port_params(jparams[0]), port_params(jparams[1]), tcfg,
        ttrain.TrainConfig(learning_rate=1e-3, warmup_steps=2,
                           total_steps=8),
        tloop.LoopConfig(output_dir=str(out), max_steps=max_steps, **kw),
        tdata.batches(data, 2, device="cpu"), log=logs.append,
        device="cpu")
    return res, logs


def test_run_training_resume_equals_straight_run(jparams, tmp_path,
                                                no_tensorboard):
    """4 steps, then 4 resumed from the checkpoint, equal 8 straight steps
    bit for bit. Checkpoints are labelled by the steps completed, the
    newest ``save_total_limit`` kept, a last one saved when the last step
    is no multiple of ``save_steps``; the resumed run logs "resumed from
    step 4" and skips the batches already trained; metrics.jsonl holds
    the logged steps."""
    a, b = tmp_path / "a", tmp_path / "b"
    res, _ = _loop_run(jparams, a, 4, save_steps=3, save_total_limit=2,
                       log_steps=2, logdir=None)
    assert res["last_step"] == 4 and tloop.saved_steps(str(a)) == [3, 4]
    res, logs = _loop_run(jparams, a, 8, save_steps=3, save_total_limit=2,
                          log_steps=2)
    assert "resumed from step 4" in logs
    assert res["last_step"] == 8 and tloop.saved_steps(str(a)) == [6, 8]
    recs = [json.loads(line) for line in open(a / "logs" / "metrics.jsonl")]
    assert [r["step"] for r in recs] == [6, 8]
    assert {"train/loss", "train/grad_norm",
            "train/seconds_per_step"} <= set(recs[0])
    straight, _ = _loop_run(jparams, b, 8, save_steps=100, logdir=None)
    assert tloop.saved_steps(str(b)) == [8]
    for n, t in ttrain.leaves(straight["params"]).items():
        assert torch.equal(ttrain.leaves(res["params"])[n], t), n
    assert res["opt_state"].count == straight["opt_state"].count == 8


def test_run_training_eval_ppl_matches_jax(jparams, tmp_path):
    """The end-of-run validation, exp of the mean loss of the validation
    batches, against JAX's loop on the same params (no step), within 1e-5
    relative; a run with no step still saves checkpoint 0."""
    jcfg, tcfg = _cfgs(w_bits=2)
    val = [IDS, _batch(20)]
    with jax.disable_jit():
        want = jloop.run_training(
            jparams[0], None, jcfg, jtrain.TrainConfig(use_kd=False),
            jloop.LoopConfig(output_dir=str(tmp_path / "jax"), max_steps=0,
                             logdir=None), iter([{"input_ids": IDS}]),
            log=lambda *_: None,
            val_batches=[{"input_ids": jnp.asarray(v)} for v in val])
    got = tloop.run_training(
        port_params(jparams[0]), None, tcfg, ttrain.TrainConfig(use_kd=False),
        tloop.LoopConfig(output_dir=str(tmp_path / "port"), max_steps=0,
                         logdir=None),
        iter([{"input_ids": torch.from_numpy(IDS)}]), log=lambda *_: None,
        val_batches=[{"input_ids": torch.from_numpy(v)} for v in val],
        device="cpu")
    assert got["last_step"] == 0 and tloop.saved_steps(
        str(tmp_path / "port")) == [0]
    assert abs(got["eval_ppl"] - want["eval_ppl"]) <= 1e-5 * want["eval_ppl"]


def test_metrics_writer_writes_jsonl(tmp_path, no_tensorboard):
    """Without TensorBoard the writer still writes metrics.jsonl, one
    record per call; with no logdir it writes nothing and raises
    nothing."""
    w = MetricsWriter(str(tmp_path / "logs"))
    w.log(3, **{"train/loss": 1.5, "eval/ppl": np.float32(2.0)})
    w.close()
    recs = [json.loads(line)
            for line in open(tmp_path / "logs" / "metrics.jsonl")]
    assert len(recs) == 1 and recs[0]["step"] == 3
    assert recs[0]["train/loss"] == 1.5 and recs[0]["eval/ppl"] == 2.0
    assert os.listdir(tmp_path / "logs") == ["metrics.jsonl"]
    MetricsWriter(None).log(1, x=1.0)


def test_profiling_matches_jax(tmp_path, monkeypatch):
    """Roofline reports as JAX's for the same peaks (the port's table holds
    only the H100's); annotate spans land in trace()'s Chrome trace;
    MetricsLogger appends JSON lines."""
    monkeypatch.setitem(tprof.CHIP_PEAKS, "v5e", jprof.CHIP_PEAKS["v5e"])
    for flops, nbytes in ((2e12, 1e9), (1e9, 4e9)):
        want = jprof.Roofline("op", nbytes, flops, chip="v5e").report(0.02)
        got = tprof.Roofline("op", nbytes, flops, chip="v5e").report(0.02)
        assert got == want
    assert set(tprof.CHIP_PEAKS) == {"h100", "v5e"}
    with tprof.trace(str(tmp_path / "t")):
        with tprof.annotate("qat_span"):
            torch.ones(4).sum()
    assert "qat_span" in (tmp_path / "t" / "trace.json").read_text()
    log = tprof.MetricsLogger(str(tmp_path / "m" / "x.jsonl"), echo=False)
    log.log(a=1)
    log.close()
    assert json.loads((tmp_path / "m" / "x.jsonl").read_text())["a"] == 1


# mxq_tpu's printed lines (mxq_tpu/qat/loop.py, mxq_tpu/cli.py cmd_train)
TRAIN_LINES = [r"step \d+: loss=-?\d+\.\d{4} gnorm=\d+\.\d{3} "
               r"\(\d+\.\d{2}s/step\)",
               r"resumed from step \d+",
               r"eval ppl \(exp of mean val loss\): \d+\.\d{4}",
               r"trained to step \d+(, eval_ppl=\d+\.\d{4})?"]


def test_cli_train_and_generate_data_print_jax_lines(tmp_path, capsys,
                                                     no_tensorboard):
    """cli train (twice: the second resumes) prints mxq_tpu's lines;
    cli generate-data prints the lines JAX's cli prints for the same
    arguments."""
    argv = ["train", "--preset", "tiny", "--device", "cpu", "--use_kd",
            "--batch_size", "2", "--block_size", "32", "--save_steps", "2",
            "--log_steps", "1", "--output_dir", str(tmp_path / "qat")]
    cli.main(argv + ["--max_steps", "2"])
    cli.main(argv + ["--max_steps", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith("trained to step 3, eval_ppl=")
    assert "resumed from step 2" in lines
    assert all(any(re.fullmatch(p, line) for p in TRAIN_LINES)
               for line in lines), lines
    gen = ["generate-data", "--preset", "tiny", "--num_seeds", "2",
           "--length", "8", "--merge"]
    cli.main(gen + ["--device", "cpu", "--out_dir", str(tmp_path / "g")])
    got = capsys.readouterr().out.replace(str(tmp_path / "g"), "DIR")
    jcli.main(gen + ["--out_dir", str(tmp_path / "j")])
    want = capsys.readouterr().out.replace(str(tmp_path / "j"), "DIR")
    assert got == want
    rows = tdata.read_jsonl_texts(str(tmp_path / "g" / "all_gen.jsonl"))
    assert [len(r.split()) for r in rows] == [8, 8]


def test_entry_points_default_to_cuda(tmp_path):
    """Without a CUDA device the QAT entry points, called without a
    device, raise instead of running on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = tl.LlamaConfig.tiny(num_hidden_layers=1)
    params = tl.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tloop.run_training(params, None, cfg, ttrain.TrainConfig(),
                           tloop.LoopConfig(output_dir=str(tmp_path)),
                           iter([]))
    with pytest.raises(RuntimeError, match="CUDA"):
        tdata.synthesize_corpus(params, cfg, np.asarray([1]), length=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        next(tdata.batches(np.zeros((4, 8), np.int32), 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        tl.sequence_classification_forward(params, IDS, cfg, num_labels=2)
    for argv in (["train", "--max_steps", "1", "--output_dir",
                  str(tmp_path / "t")],
                 ["generate-data", "--out_dir", str(tmp_path / "g")]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv + ["--preset", "tiny", "--layers", "1"])
    assert not os.listdir(tmp_path)
