"""Rank functions of the port's multi-rank CPU tests, and the launcher that
runs them: each test module starts its ranks once (``spawn``), every rank
joins a gloo group through a ``FileStore`` in the test's temporary
directory, runs one function of this module and saves what it returns for
the test process to compare. A child of ``spawn`` imports the module that
holds its target again, so this module imports only torch and the port
(the test files import JAX).

A rank that hangs in a collective fails after ``TIMEOUT`` (gloo's own
timeout); the launcher gives the ranks ``JOIN_TIMEOUT`` and then kills
them and raises, so a hung ring fails its test in seconds, not the run."""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(seconds=60)
JOIN_TIMEOUT = 240.0


def _entry(fn_name: str, rank: int, world: int, root: str, payload):
    torch.set_num_threads(1)
    out = os.path.join(root, f"rank{rank}.pt")
    try:
        store = dist.FileStore(os.path.join(root, "store"), world)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world, timeout=TIMEOUT)
        try:
            res = globals()[fn_name](rank, world, payload)
        finally:
            dist.destroy_process_group()
        torch.save({"ok": res}, out)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, out)
        raise


class Ranks:
    """``world`` ranks running ``fn_name(rank, world, payload)``, started at
    once; :meth:`results` joins them and returns each rank's result."""

    def __init__(self, fn_name: str, world: int, root: str, payload=None):
        os.makedirs(root, exist_ok=True)
        self.root, self.world = root, world
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_entry,
                                  args=(fn_name, r, world, root, payload),
                                  daemon=True) for r in range(world)]
        for p in self.procs:
            p.start()

    def results(self) -> list:
        for p in self.procs:
            p.join(JOIN_TIMEOUT)
        hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        if hung:
            raise TimeoutError(f"ranks {hung} still running after "
                               f"{JOIN_TIMEOUT} s")
        out = []
        for r in range(self.world):
            path = os.path.join(self.root, f"rank{r}.pt")
            if not os.path.exists(path):
                raise RuntimeError(f"rank {r} exited "
                                   f"{self.procs[r].exitcode} with no result")
            res = torch.load(path, weights_only=False)
            if "error" in res:
                raise RuntimeError(f"rank {r} failed:\n{res['error']}")
            out.append(res["ok"])
        return out


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


def _tiny(**kw):
    from mxq_tpu_torch.models import llama
    return llama.LlamaConfig.tiny(**kw)


def qat_steps(rank, world, p):
    """``p["steps"]`` KD train steps of the tiny model (w_bits 2, remat) on
    FSDP2 shards over ``make_mesh(*p["mesh"])``: the loss (mean over the
    ranks) and grad_norm of each step, and on rank 0 the params after."""
    from mxq_tpu_torch import weights
    from mxq_tpu_torch.parallel import fsdp, multihost, sharding
    from mxq_tpu_torch.qat import train
    cfg = _tiny(w_bits=2)
    mesh = sharding.make_mesh(*p["mesh"])
    student = fsdp.ShardedLlama(weights.params_from_numpy(p["student"],
                                                          "cpu"), cfg, mesh)
    teacher = fsdp.ShardedLlama(weights.params_from_numpy(p["teacher"],
                                                          "cpu"),
                                _tiny(), mesh, requires_grad=False)
    tc = train.TrainConfig(**p["tc"])
    step = train.make_train_step(cfg, tc, train.make_optimizer(tc, student))
    losses, norms = [], []
    for ids in p["batches"]:
        m = step(student, teacher, multihost.local_batch(
            {"input_ids": torch.from_numpy(ids)}, mesh))
        losses.append(float(fsdp.all_mean(m["loss"])))
        norms.append(float(m["grad_norm"]))
    full = fsdp.stack_full(student.named_leaves())
    return {"loss": losses, "grad_norm": norms,
            "params": {k: _np(v) for k, v in full.items()} if rank == 0
            else None}


def _weights(d: dict, packed: bool) -> dict:
    """Numpy weights -> tensors: [in, out] dense, or each linear packed
    from its transpose (the port's packer, bit-equal to mxq_tpu's)."""
    from mxq_tpu_torch import packfmt
    out = {}
    for k, v in d.items():
        t = torch.from_numpy(v)
        out[k] = packfmt.quantize_pack(t.T.contiguous()) if (
            packed and t.dim() == 2) else t
    return out


# name -> (kind, packed, seed, tp): the rings and layers of
# test_torch_overlap.py, at the widths of tests/test_overlap.py
RING_CASES = {
    "block": ("block", False, 0, 2), "block_packed": ("block", True, 2, 2),
    "mlp": ("mlp", False, 6, 2), "mlp_packed": ("mlp", True, 5, 2),
    "decode": ("decode", False, 7, 2), "decode_packed": ("decode", True, 8, 2),
    "decode_gqa": ("decode", False, 14, 2),
    "prefill": ("prefill", False, 12, 2),
    "prefill_packed": ("prefill", True, 13, 2),
    "prefill_gqa": ("prefill", False, 15, 2),
    "block_tp4": ("block", False, 1, 4),
}
LAYER_CFG = dict(hidden_size=2048, intermediate_size=2048,
                 num_attention_heads=16, num_key_value_heads=16,
                 vocab_size=128)


def ring_inputs(name: str) -> dict:
    """The numpy inputs of ``RING_CASES[name]``, drawn from its seed:
    ``x``, the weights ``w`` ([in, out]; a packed case packs each one's
    transpose), and for the layers the config, the f32 caches and the
    decode positions."""
    kind, packed, seed, tp = RING_CASES[name]
    rng = np.random.RandomState(seed)

    def mat(i, o, scale):
        return (rng.randn(i, o) * scale).astype(np.float32)

    if kind == "block":
        k = 2048 * tp // 2
        x = rng.randn(4 if not packed and tp == 2 else 2, k).astype(
            np.float32)
        scale = 1.0 if packed else 0.05
        return dict(x=x, w=dict(wc=mat(k, k, scale), wr=mat(k, k, scale)))
    if kind == "mlp":
        x = (rng.randn(2, 2048) * 0.3).astype(np.float32)
        scale = 0.2 if packed else 0.05
        return dict(x=x, w=dict(gate=mat(2048, 2048, scale),
                                up=mat(2048, 2048, scale),
                                down=mat(2048, 2048, scale)))
    gqa = name.endswith("gqa")
    cfg = dict(LAYER_CFG, num_key_value_heads=4 if gqa else 16)
    h, kv = 2048, (4 if gqa else 16) * 128
    scale = 0.05 if packed else 0.02
    w = {n: mat(h, o, scale) for n, o in (
        ("q_proj", h), ("k_proj", kv), ("v_proj", kv), ("o_proj", h),
        ("gate_proj", 2048), ("up_proj", 2048))}
    w["down_proj"] = mat(2048, h, scale)
    w["input_layernorm"] = np.ones(h, np.float32)
    w["post_attention_layernorm"] = np.ones(h, np.float32)
    shape = (2, 8, h) if kind == "prefill" else (2, h)
    x = (rng.randn(*shape) * 0.3).astype(np.float32)
    cache = {k: np.zeros((2, 16, kv // 128, 128), np.float32)
             for k in ("k", "v")}
    positions = np.array([5, 11] if packed else [3, 7], np.int32)
    return dict(x=x, w=w, cfg=cfg, cache=cache, positions=positions)


def ring_cases(rank, world, p):
    """The tensor-parallel rings and layers over all ``world`` ranks as one
    tp group: for each case of ``p["cases"]`` (names of
    :data:`RING_CASES`) this rank's output (its K-chunk; for the layers
    also its head-shard of the cache)."""
    import functools
    from mxq_tpu_torch.models import llama
    from mxq_tpu_torch.parallel import overlap, sharding, tp_layer
    mesh = sharding.make_mesh(1, 1, world)
    matmul = functools.partial(llama.quant_linear, cfg=llama.LlamaConfig())
    out = {}
    for name in p["cases"]:
        kind, packed, _, _ = RING_CASES[name]
        c = ring_inputs(name)
        w = _weights(c["w"], packed)
        x = torch.from_numpy(c["x"])
        x_sh = x.chunk(world, dim=-1)[rank].contiguous()
        cols = x.shape[-1] // world
        if kind in ("block", "mlp"):
            n_ktl = x.shape[-1] // overlap.KT_COLS // world
            row = w["wr" if kind == "block" else "down"]
            rows = overlap.row_chunks(overlap.shard_weight(
                row, "k", rank, world), world, cols)
            if kind == "block":
                y = overlap.tp_block_matmuls(
                    mesh, x_sh, overlap.shard_weight(w["wc"], "n", rank,
                                                     world),
                    rows, matmul, n_ktiles_local=n_ktl)
            else:
                y = overlap.tp_packed_mlp(
                    mesh, x_sh, overlap.shard_weight(w["gate"], "n", rank,
                                                     world),
                    overlap.shard_weight(w["up"], "n", rank, world), rows,
                    matmul, n_ktiles_local=n_ktl)
            out[name] = _np(y)
            continue
        cfg = llama.LlamaConfig.tiny(**c["cfg"])
        layer = tp_layer.shard_layer(w, rank, world)
        cache = {k: torch.from_numpy(v).chunk(world, dim=2)[rank]
                 .contiguous() for k, v in c["cache"].items()}
        if kind == "decode":
            y, cache = tp_layer.tp_decode_layer(
                mesh, x_sh, layer, cache, torch.from_numpy(c["positions"]),
                cfg, matmul)
        else:
            y, cache = tp_layer.tp_prefill_layer(mesh, x_sh, layer, cache,
                                                 cfg, matmul)
        out[name] = (_np(y), _np(cache["k"]), _np(cache["v"]))
    return out


def jobs(rank, world, p):
    """Several rank functions in one group, one after another:
    ``p[name] = (function name, payload)``; returns their results by
    name."""
    return {name: globals()[fn](rank, world, arg)
            for name, (fn, arg) in p.items()}


def _no_tensorboard():
    """MetricsWriter without TensorBoard (importing it takes ~10 s)."""
    import sys
    sys.modules["torch.utils.tensorboard"] = None


def loop_resume(rank, world, p):
    """``run_training`` on ``make_mesh(*p["mesh"])``: 2 steps, then resumed
    to 4, and 4 straight steps in another directory; the params and
    losses of both, the logs and checkpoints of the resumed run."""
    from mxq_tpu_torch import weights
    from mxq_tpu_torch.parallel import sharding
    from mxq_tpu_torch.qat import loop, train
    _no_tensorboard()
    cfg = _tiny(w_bits=2)
    mesh = sharding.make_mesh(*p["mesh"])
    out = {}

    def run(name, steps, log):
        lc = loop.LoopConfig(output_dir=os.path.join(p["dir"], name),
                             save_steps=2, log_steps=1, max_steps=steps)
        res = loop.run_training(
            weights.params_from_numpy(p["student"], "cpu"),
            weights.params_from_numpy(p["teacher"], "cpu"), cfg,
            train.TrainConfig(total_steps=10), lc,
            iter([{"input_ids": torch.from_numpy(b)} for b in p["batches"]]),
            mesh=mesh, log=log, device="cpu")
        return res, sorted(os.listdir(lc.output_dir))

    logs = []
    run("a", 2, logs.append)
    res, ckpts = run("a", 4, logs.append)
    straight, _ = run("b", 4, lambda *_: None)
    out = {"logs": logs, "checkpoints": ckpts,
           "losses": res["losses"], "straight_losses": straight["losses"],
           "count": res["opt_state"].count}
    if rank == 0:
        out["params"] = train.leaves(res["params"])
        out["straight"] = train.leaves(straight["params"])
    return out


def cli_run(rank, world, p):
    """``cli.main(p["argv"])`` on every rank: its result and what each
    rank printed."""
    import contextlib
    import io
    from mxq_tpu_torch import cli
    _no_tensorboard()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = cli.main(p["argv"])
    return {"printed": buf.getvalue(),
            "result": {k: v for k, v in res.items()
                       if k in ("dataset", "ppl", "last_step", "losses",
                                "eval_ppl")}}


def sharded_forward(rank, world, p):
    """The logits of this rank's rows through ``ShardedLlama`` on
    ``make_mesh(*p["mesh"])`` (tiny model, no training)."""
    from mxq_tpu_torch import weights
    from mxq_tpu_torch.parallel import fsdp, multihost, sharding
    mesh = sharding.make_mesh(*p["mesh"])
    model = fsdp.ShardedLlama(weights.params_from_numpy(p["params"], "cpu"),
                              _tiny(), mesh, requires_grad=False)
    ids = multihost.local_batch({"ids": torch.from_numpy(p["ids"])},
                                mesh)["ids"]
    with torch.no_grad():
        return {"rows": multihost.host_local_slice(len(p["ids"]), mesh),
                "logits": _np(model(ids))}


def ptq_sharded(rank, world, p):
    """Sharded ``ptq_quantize`` of the tiny model (packed mode) on
    ``make_mesh(*p["mesh"])``, the params given whole or as
    ``shard_params``' DTensors: each rank's local shapes of the dense
    projections, and on rank 0 the gathered results."""
    from mxq_tpu_torch import weights
    from mxq_tpu_torch.models import llama
    from mxq_tpu_torch.parallel import sharding
    from mxq_tpu_torch.ptq import calibrate
    cfg = llama.LlamaConfig.tiny()
    mesh = sharding.make_mesh(*p["mesh"])
    params = weights.params_from_numpy(p["params"], "cpu")
    if p["shard_input"]:
        params = sharding.shard_params(params, mesh)
    q, packed = calibrate.ptq_quantize(
        params, cfg, p["ids"], calibrate.PTQConfig(mode="packed",
                                                   chunk=p["chunk"]),
        device="cpu", mesh=mesh)
    local = {k: tuple(v.to_local().shape) for k, v in q["layers"].items()
             if k in llama.LAYER_LINEARS}
    q, packed = sharding.gather_params(q), sharding.gather_params(packed)
    if rank:
        return {"local": local}
    return {"local": local, "q": q["layers"],
            "packed": {k: v for k, v in packed["layers"].items()
                       if k in llama.LAYER_LINEARS}}


# the serving runs of test_torch_multihost_serving.py: the tiny preset at 2
# layers, packed and fused, served with this config
SERVE_ECFG = dict(num_slots=2, max_len=32, prefill_buckets=(8,),
                  kv_quant=False, horizon=4)
SERVE_PROMPT = np.arange(6, dtype=np.int32) + 3
SPEC_PROMPT = np.array([3, 4, 5] * 4, np.int32)


def sharded_serving(rank, world, p):
    """The tiny packed model served over every rank: the Engine sharded by
    ``shard_engine`` on ``make_mesh(*p["mesh"])``, speculative decoding
    (``spec.run_spec``, draft 3) on another such Engine, and
    ``MultiHostEngine`` on ``make_hybrid_mesh(*p["hybrid"])`` with
    ``dcn_role="tp"``, submitted with rank 0's prompt only. Each run's
    greedy tokens, the uid and stats of the MultiHostEngine's request, and
    the logits of one more decode step of each sharded engine."""
    from mxq_tpu_torch import weights
    from mxq_tpu_torch.models import llama
    from mxq_tpu_torch.parallel import multihost, sharding
    from mxq_tpu_torch.serving import engine as eng
    from mxq_tpu_torch.serving import multihost as mh
    from mxq_tpu_torch.serving import spec
    cfg = _tiny(num_hidden_layers=2)
    packed = weights.params_from_numpy(p["packed"], "cpu")
    ecfg = eng.EngineConfig(**SERVE_ECFG)
    mesh = sharding.make_mesh(*p["mesh"])

    def probe(e):
        toks = torch.tensor([[7], [11]], dtype=torch.int32)
        return _np(e._decode_fn(e.params, toks, cfg, e.caches,
                                torch.tensor([20, 9], dtype=torch.int32)))

    out = {}
    e = mh.shard_engine(eng.Engine(packed, cfg, ecfg, device="cpu"), mesh)
    r = e.submit(SERVE_PROMPT, max_new_tokens=5)
    e.run()
    out["engine"] = list(r.generated)
    out["engine_logits"] = probe(e)
    out["local_qkv_cols"] = e.params["layers"]["qkv_proj"].out_features
    out["local_cache_heads"] = e.caches["k"].shape[3]
    e = mh.shard_engine(eng.Engine(packed, cfg, eng.EngineConfig(
        **dict(SERVE_ECFG, horizon=8)), device="cpu"), mesh)
    r = e.submit(SPEC_PROMPT, max_new_tokens=5)
    spec.run_spec(e, draft_len=3)
    out["spec"] = list(r.generated)
    out["spec_rounds"] = e.stats().get("spec_verify_rounds", 0)
    hybrid = multihost.make_hybrid_mesh(*p["hybrid"])
    m = mh.MultiHostEngine(packed, cfg, hybrid, ecfg, dcn_role="tp",
                           device="cpu")
    r = m.submit(SERVE_PROMPT if rank == 0 else None, max_new_tokens=5)
    m.run()
    out["multihost"] = list(r.generated)
    out["multihost_uid"] = r.uid
    out["multihost_prompt"] = r.prompt.tolist()
    out["multihost_finished"] = m.stats()["requests_finished"]
    out["multihost_logits"] = probe(m.engine)
    out["multihost_local_o_cols"] = \
        m.engine.params["layers"]["o_proj"].out_features
    return out
