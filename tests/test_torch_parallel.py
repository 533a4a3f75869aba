"""The port's mesh and sharding (parallel/multihost, parallel/sharding,
parallel/fsdp), sharded PTQ (ptq_quantize(mesh=), cli ptq --shard) and
FSDP2 QAT (run_training(mesh=), cli train over every rank) against
mxq_tpu's on the 8-virtual-device mesh and against the port's unsharded
runs, on the tiny preset.

The multi-rank cases run in gloo ranks that each test module starts once
(tests/torch_dist_workers.py: 2 and 4 ranks, spawned, rendezvous through a
FileStore in a temporary directory, 60 s collective timeout); specs and
shard shapes over 8 ranks use torch's fake process group in this process
(no data moves in ``shard_params``: each rank slices its own shard)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

from mxq_tpu.models import llama as jl
from mxq_tpu.parallel import multihost as jmh
from mxq_tpu.parallel import sharding as jsh
from mxq_tpu.qat import train as jtrain
from mxq_tpu_torch import cli, packfmt, weights
from mxq_tpu_torch.models import llama as tl
from mxq_tpu_torch.parallel import multihost, sharding
from mxq_tpu_torch.ptq import calibrate
from mxq_tpu_torch.qat import train as ttrain
from mxq_tpu_torch.utils import checkpoint
from torch_dist_workers import Ranks
from torch_port_helpers import rel, to_numpy_tree

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

CAL_IDS = np.random.default_rng(0).integers(0, 512, (4, 32))
BATCHES = [np.random.default_rng(10 + k).integers(0, 512, (4, 32))
           for k in range(4)]
TC = dict(total_steps=10, use_kd=True, remat=True)
# the PTQ, train and eval arguments of the cli runs
PTQ_ARGV = ["ptq", "--device", "cpu", "--preset", "tiny", "--mode",
            "packed", "--nsamples", "4", "--seqlen", "32",
            "--max_eval_windows", "1"]
TRAIN_ARGV = ["train", "--device", "cpu", "--preset", "tiny", "--use_kd",
              "--batch_size", "2", "--block_size", "32", "--max_steps", "3",
              "--log_steps", "1", "--save_steps", "100"]


@pytest.fixture(scope="module")
def jparams():
    cfg = jl.LlamaConfig.tiny()
    return (jl.init_params(cfg, jax.random.PRNGKey(0)),
            jl.init_params(cfg, jax.random.PRNGKey(1)))


@pytest.fixture(scope="module")
def ranks(jparams, tmp_path_factory):
    """Both groups of gloo ranks, started at once: 2 ranks (sharded PTQ
    at dp 2, QAT at fsdp 2, the loop's resume, cli ptq --shard, cli
    train) and 4 ranks (PTQ at fsdp 2 x tp 2 from sharded params with
    chunks of 1, QAT at dp 2 x fsdp 2, the sharded forward)."""
    root = tmp_path_factory.mktemp("ranks")
    student, teacher = (to_numpy_tree(p) for p in jparams)
    qat = dict(student=student, teacher=teacher, batches=BATCHES[:3],
               tc=TC)
    two = {"ptq": ("ptq_sharded", dict(mesh=(2, 1, 1), params=student,
                                       ids=CAL_IDS, chunk=None,
                                       shard_input=False)),
           "qat": ("qat_steps", dict(qat, mesh=(1, 2, 1))),
           "loop": ("loop_resume", dict(mesh=(1, 2, 1), student=student,
                                        teacher=teacher, batches=BATCHES,
                                        dir=str(root / "loop"))),
           "cli_ptq": ("cli_run", dict(argv=PTQ_ARGV + [
               "--shard", "2,1,1", "--save_model", str(root / "ptq")])),
           "cli_train": ("cli_run", dict(argv=TRAIN_ARGV + [
               "--output_dir", str(root / "train")]))}
    four = {"ptq": ("ptq_sharded", dict(mesh=(1, 2, 2), params=student,
                                        ids=CAL_IDS, chunk=1,
                                        shard_input=True)),
            "qat": ("qat_steps", dict(qat, mesh=(2, 2, 1))),
            "forward": ("sharded_forward", dict(mesh=(2, 1, 2),
                                                params=student,
                                                ids=BATCHES[0]))}
    started = {2: Ranks("jobs", 2, str(root / "w2"), two),
               4: Ranks("jobs", 4, str(root / "w4"), four)}
    done = {}

    def results(world):
        if world not in done:
            done[world] = started[world].results()
        return done[world]

    results.root = root
    yield results
    for w in started:
        results(w)          # never leave a rank running


def _trees_equal(a: dict, b: dict) -> list:
    """The paths at which two checkpoints' params differ."""
    fa, fb = (checkpoint._flatten(t)[0] for t in (a, b))
    return sorted(k for k in set(fa) | set(fb)
                  if k not in fa or k not in fb
                  or not torch.equal(fa[k], fb[k]))


# ---------------------------------------------------------------------------
# specs and shard shapes (no ranks)
# ---------------------------------------------------------------------------


def _jax_spec_leaves(tree):
    return jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))


def _path(path) -> str:
    return ".".join(str(getattr(p, "key", getattr(p, "name", p)))
                    for p in path)


def _port_spec_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_port_spec_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@functools.cache
def _both_params(kind):
    """(JAX params, the port's) of the one-layer tiny model: dense,
    packed unfused or packed fused."""
    cfg = jl.LlamaConfig.tiny(num_hidden_layers=1)
    jp = jl.init_params(cfg, jax.random.PRNGKey(0))
    if kind != "dense":
        jp = jl.quantize_params_packed(jp, cfg, fuse=kind == "fused")
    return jp, weights.params_from_numpy(to_numpy_tree(jp), "cpu")


@pytest.mark.parametrize("role", [None, "fsdp", "tp"])
@pytest.mark.parametrize("kind", ["dense", "packed", "fused"])
def test_param_specs_match_jax(kind, role):
    """param_specs names the same axes as mxq_tpu's table, leaf for leaf
    (a JAX PartitionSpec is the tuple of its entries), dense and packed
    (fused and not), for every dcn_role."""
    jp, tp = _both_params(kind)
    packed = kind != "dense"
    want = {_path(p): tuple(s) for p, s in
            _jax_spec_leaves(jsh.param_specs(jp, packed, role))}
    got = _port_spec_leaves(sharding.param_specs(tp, packed, role))
    assert got == want


@pytest.fixture
def fake_rank():
    """``join(r, world)`` makes this process rank r of a fake process
    group (no data moves); left at the end of the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def join(r, world):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=r,
                                world_size=world)

    yield join
    if dist.is_initialized():
        dist.destroy_process_group()


def _jax_mesh(hybrid):
    return (jmh.make_hybrid_mesh(dcn=2, fsdp=2, tp=2) if hybrid
            else jsh.make_mesh(2, 2, 2))


def _port_mesh(hybrid):
    return (multihost.make_hybrid_mesh(dcn=2, fsdp=2, tp=2) if hybrid
            else sharding.make_mesh(2, 2, 2))


@pytest.mark.parametrize("hybrid", [False, True], ids=["ici", "hybrid"])
@pytest.mark.parametrize("kind", ["dense", "packed"])
def test_shard_shapes_match_jax(kind, hybrid, fake_rank):
    """Each of 8 ranks' local shard of every leaf (shard_params, dcn_role
    "tp" on the hybrid mesh) has the shape of
    NamedSharding(mesh, spec).shard_shape on mxq_tpu's 8-device mesh,
    and for dense params the data of device r's shard."""
    jp, tp = _both_params(kind)
    role = "tp" if hybrid else None
    packed = kind != "dense"
    jmesh = _jax_mesh(hybrid)
    specs = dict((_path(p), s) for p, s in
                 _jax_spec_leaves(jsh.param_specs(jp, packed, role)))
    leaves = dict((_path(p), np.asarray(x)) for p, x in
                  jax.tree_util.tree_leaves_with_path(jp))
    want = {k: NamedSharding(jmesh, specs[k]).shard_shape(v.shape)
            for k, v in leaves.items()}
    shards = {}
    if not packed:
        placed = jsh.shard_params(jp, jmesh, dcn_role=role)
        shards = {_path(p): {s.device.id: np.asarray(s.data)
                             for s in x.addressable_shards}
                  for p, x in jax.tree_util.tree_leaves_with_path(placed)}
    for r in range(8):
        fake_rank(r, 8)
        sp = sharding.shard_params(tp, _port_mesh(hybrid), packed, role)
        got = {}
        for name, t in ttrain.leaves({k: v for k, v in sp.items()
                                      if k != "layers"}).items():
            got[name] = t
        for name, t in sp["layers"].items():
            if isinstance(t, packfmt.PackedMXQLinear):
                got.update({f"layers.{name}.{f}": getattr(t, f)
                            for f in packfmt.FIELDS})
            else:
                got[f"layers.{name}"] = t
        assert set(got) == set(want)
        for name, t in got.items():
            assert tuple(t.to_local().shape) == tuple(want[name]), (r, name)
            if shards:
                assert np.array_equal(t.to_local().numpy(),
                                      shards[name][r]), (r, name)


def test_initialize_single_process_is_noop(monkeypatch):
    """With no torchrun environment initialize joins nothing; this
    process is the coordinator of a world of 1."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert multihost.initialize("cpu") is False
    assert not dist.is_initialized()
    assert multihost.is_coordinator() and multihost.world_size() == 1
    multihost.sync_global_devices()


def test_hybrid_mesh_batch_spec_and_slices(fake_rank, monkeypatch):
    """tests/test_multihost.py's cases over 8 ranks: the hybrid mesh's
    axes and shape; batch_spec covers the data axes only (as mxq_tpu's);
    host_local_slice partitions 16 rows by rank, and by the data
    coordinate on a mesh (tp neighbours share rows); global_batch keeps
    2 of 8 rows on each rank over dcn 2 x fsdp 2, shard_batch a rank's
    rows of a whole batch over dp 2 x fsdp 2; across 2 nodes dcn must be
    the node count."""
    jmesh = jmh.make_hybrid_mesh(dcn=2, dp=1, fsdp=2, tp=2)
    for r in range(8):
        fake_rank(r, 8)
        mesh = multihost.make_hybrid_mesh(dcn=2, dp=1, fsdp=2, tp=2)
        assert mesh.mesh_dim_names == jmesh.axis_names
        assert multihost.mesh_axes(mesh) == dict(jmesh.shape)
        assert multihost.batch_spec(mesh) == tuple(jmh.batch_spec(jmesh))
        assert sharding.batch_spec(mesh) == tuple(jsh.batch_spec(jmesh))
        ici = sharding.make_mesh(2, 2, 2)
        assert sharding.batch_spec(ici) == tuple(
            jsh.batch_spec(jsh.make_mesh(2, 2, 2)))
        assert multihost.host_local_slice(16) == slice(2 * r, 2 * r + 2)
        assert multihost.host_local_slice(16, mesh) == slice(
            4 * (r // 2), 4 * (r // 2) + 4)
        with pytest.raises(ValueError, match="divisible"):
            multihost.host_local_slice(6)
        rows = multihost.host_local_slice(8, mesh)
        b = multihost.global_batch(
            {"input_ids": np.ones((8, 4), np.int32)[rows]}, mesh)
        assert tuple(b["input_ids"].to_local().shape) == (2, 4)
        assert tuple(b["input_ids"].shape) == (8, 4)
        whole = np.arange(32, dtype=np.int32).reshape(8, 4)
        local = sharding.shard_batch({"ids": whole}, ici)["ids"].to_local()
        assert np.array_equal(local.numpy(), whole[2 * (r // 2):
                                                   2 * (r // 2) + 2])
        assert multihost.is_coordinator() == (r == 0)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="number of nodes"):
        multihost.make_hybrid_mesh(dcn=1, dp=2, fsdp=2, tp=2)
    assert multihost.mesh_axes(multihost.make_hybrid_mesh(
        dcn=2, fsdp=2, tp=2))["dcn"] == 2


# ---------------------------------------------------------------------------
# sharded PTQ
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_ptq_equals_chunked_run(jparams, ranks, world):
    """ptq_quantize on 2 data ranks (dp 2, whole params; fsdp 2 x tp 2,
    shard_params' DTensors, chunks of 1) equals the unsharded run with
    the same chunk bit for bit: every dequantized weight and every packed
    plane; each rank held only its shard of the projections."""
    res = ranks(world)
    chunk = 2 if world == 2 else 1
    params = weights.params_from_numpy(to_numpy_tree(jparams[0]), "cpu")
    q, packed = calibrate.ptq_quantize(
        params, tl.LlamaConfig.tiny(), CAL_IDS,
        calibrate.PTQConfig(mode="packed", chunk=chunk), device="cpu")
    got = res[0]["ptq"]
    for name in tl.LAYER_LINEARS:
        assert torch.equal(got["q"][name], q["layers"][name]), name
        for f in packfmt.FIELDS:
            assert torch.equal(getattr(got["packed"][name], f),
                               getattr(packed["layers"][name], f)), (name, f)
    split = {2: (1, 1), 4: (2, 2)}[world]      # (fsdp, tp) of the mesh
    for r in res:
        local = r["ptq"]["local"]
        assert local["q_proj"] == (2, 256 // split[0], 256 // split[1])
        assert local["down_proj"] == (2, 512 // split[1], 256 // split[0])


def test_cli_ptq_shard_equals_unsharded(ranks, tmp_path):
    """cli ptq --shard 2,1,1 on 2 ranks prints mxq_tpu's lines once (on
    rank 0) and saves the checkpoint of the unsharded run with --chunk 2,
    tensor for tensor; both perplexities are equal."""
    res = ranks(2)
    want = cli.main(PTQ_ARGV + ["--chunk", "2", "--save_model",
                                str(tmp_path / "ref")])
    printed = res[0]["cli_ptq"]["printed"]
    assert "sharding calibration over mesh (dp=2, fsdp=1, tp=1)" in printed
    assert printed.count("  layer ") == 2 and "ppl (quantized)" in printed
    assert res[1]["cli_ptq"]["printed"] == ""
    assert all(r["cli_ptq"]["result"]["ppl"] == want["ppl"] for r in res)
    cfg, got = checkpoint.load_params(str(ranks.root / "ptq"), "cpu")
    ref_cfg, ref = checkpoint.load_params(str(tmp_path / "ref"), "cpu")
    assert cfg == ref_cfg and _trees_equal(got, ref) == []


# ---------------------------------------------------------------------------
# FSDP2 QAT
# ---------------------------------------------------------------------------


def _unsharded_steps(jparams, steps):
    cfg = tl.LlamaConfig.tiny(w_bits=2)
    params = weights.params_from_numpy(to_numpy_tree(jparams[0]), "cpu")
    for t in ttrain.leaves(params).values():
        t.requires_grad_(True)
    teacher = weights.params_from_numpy(to_numpy_tree(jparams[1]), "cpu")
    tc = ttrain.TrainConfig(**TC)
    step = ttrain.make_train_step(cfg, tc, ttrain.make_optimizer(tc, params))
    ms = [step(params, teacher, {"input_ids": torch.from_numpy(b)})
          for b in BATCHES[:steps]]
    return ([float(m["loss"]) for m in ms],
            [float(m["grad_norm"]) for m in ms], ttrain.leaves(params))


@pytest.mark.parametrize("world", [2, 4], ids=["fsdp2", "dp2xfsdp2"])
def test_sharded_qat_steps_match_unsharded(jparams, ranks, world):
    """3 KD steps (w_bits 2, remat, lr 2e-5) on FSDP2 shards (fsdp 2; dp 2
    x fsdp 2, HSDP) against the port's unsharded steps on the whole
    batch: the loss (mean over the ranks) and grad_norm within 1e-5
    relative, every parameter after the steps within 1e-5 of its leaf's
    max|p| (test_train_steps_match_jax's gate; measured 2.9e-7 and
    2.8e-7, losses 1.5e-7, grad_norms 1.1e-7)."""
    got = ranks(world)[0]["qat"]
    losses, norms, params = _unsharded_steps(jparams, 3)
    for k in range(3):
        assert abs(got["loss"][k] - losses[k]) <= 1e-5 * losses[k], k
        assert abs(got["grad_norm"][k] - norms[k]) <= 1e-5 * norms[k], k
    for n, t in params.items():
        assert rel(torch.from_numpy(got["params"][n]), t.detach()) <= 1e-5, n


def test_sharded_qat_steps_match_jax_sharded(jparams, ranks):
    """The same 3 steps at fsdp 2 against mxq_tpu's jitted step with its
    params, teacher and batches sharded on the virtual mesh (dp 1, fsdp
    2, tp 1): loss, grad_norm and every parameter within 1e-5,
    relative."""
    got = ranks(2)[0]["qat"]
    jcfg = jl.LlamaConfig.tiny(w_bits=2)
    mesh = jsh.make_mesh(dp=1, fsdp=2, tp=1)
    js = jsh.shard_params(jparams[0], mesh)
    jt = jsh.shard_params(jparams[1], mesh)
    jopt = jtrain.make_optimizer(jtrain.TrainConfig(**TC))
    jstep = jax.jit(jtrain.make_train_step(jcfg, jtrain.TrainConfig(**TC),
                                          jopt))
    state = jopt.init(js)
    for k in range(3):
        batch = jsh.shard_batch({"input_ids": jnp.asarray(BATCHES[k])},
                                mesh)
        js, state, jm = jstep(js, jt, state, batch)
        for key in ("loss", "grad_norm"):
            want = float(jm[key])
            assert abs(got[key][k] - want) <= 1e-5 * abs(want), (k, key)
    want = ttrain.leaves(jax.tree_util.tree_map(np.asarray, js))
    for n, v in want.items():
        assert rel(torch.from_numpy(got["params"][n]), v) <= 1e-5, n


def test_run_training_mesh_resumes_and_equals_straight(ranks):
    """run_training(mesh=fsdp 2): 2 steps, then resumed to 4 from the
    whole-tensor checkpoint (each rank reloading its shards), equal 4
    straight steps bit for bit; "resumed from step 2" logged once (rank
    0), checkpoint 4 the one kept."""
    res = ranks(2)
    for r, out in enumerate(res):
        lp = out["loop"]
        assert lp["checkpoints"] == ["4", "logs"], r
        assert lp["count"] == 4
        assert lp["losses"] == lp["straight_losses"][2:]
        assert ("resumed from step 2" in lp["logs"]) == (r == 0)
    lp = res[0]["loop"]
    for n, t in lp["straight"].items():
        assert torch.equal(lp["params"][n], t), n


def test_loop_checkpoint_is_the_unsharded_format(ranks):
    """The sharded run's checkpoint holds whole, stacked tensors in the
    port's files: utils.checkpoint loads the params the run returned, and
    the optimizer file has both moments of every stacked leaf."""
    from mxq_tpu_torch.utils import safetensors_io
    lp = ranks(2)[0]["loop"]
    d = ranks.root / "loop" / "b" / "4"
    cfg, params = checkpoint.load_params(str(d), "cpu")
    assert cfg == tl.LlamaConfig.tiny(w_bits=2)
    got = ttrain.leaves(params)
    assert set(got) == set(lp["straight"])
    for n, t in lp["straight"].items():
        assert torch.equal(got[n], t), n
    opt = dict(safetensors_io.iter_tensors(str(d / "optimizer.safetensors")))
    assert int(opt["count"]) == 4
    for n, t in got.items():
        for m in ("exp_avg", "exp_avg_sq"):
            assert opt[f"{m}.{n}"].shape == t.shape, (m, n)


def test_sharded_forward_matches_unsharded(jparams, ranks):
    """ShardedLlama on dp 2 x tp 2 (each rank its 2 of 4 rows) equals
    llama.forward of the whole batch within 2e-4
    (tests/test_sharding.py's gate)."""
    params = weights.params_from_numpy(to_numpy_tree(jparams[0]), "cpu")
    want, _ = tl.forward(params, BATCHES[0], tl.LlamaConfig.tiny(),
                         device="cpu")
    for r in ranks(4):
        sl = r["forward"]["rows"]
        np.testing.assert_allclose(r["forward"]["logits"],
                                   want[sl].numpy(), rtol=2e-4, atol=2e-4)


def test_cli_train_shards_over_every_rank(ranks, tmp_path, monkeypatch):
    """cli train on 2 ranks (fsdp = gcd(2, batch_size 2) = 2) logs each
    step once, on rank 0, with the losses of the unsharded cli train
    within 1e-5 relative, and writes one checkpoint whose params equal
    the unsharded run's within 1e-5 of each leaf's max|p|."""
    import sys
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    res = ranks(2)
    want = cli.main(TRAIN_ARGV + ["--output_dir", str(tmp_path / "ref")])
    printed = res[0]["cli_train"]["printed"]
    assert printed.count("step ") >= 3 and "trained to step 3" in printed
    assert res[1]["cli_train"]["printed"] == ""
    for r in res:
        got = r["cli_train"]["result"]["losses"]
        assert len(got) == 3
        for a, b in zip(got, want["losses"]):
            assert abs(a - b) <= 1e-5 * b
    _, got = checkpoint.load_params(str(ranks.root / "train" / "3"), "cpu")
    _, ref = checkpoint.load_params(str(tmp_path / "ref" / "3"), "cpu")
    ref = ttrain.leaves(ref)
    for n, t in ttrain.leaves(got).items():
        assert rel(t, ref[n]) <= 1e-5, n
