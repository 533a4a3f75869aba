"""The port's multi-rank serving (mxq_tpu_torch/serving/multihost.py)
against mxq_tpu's on the CPU: kv_cache_spec equals mxq_tpu's; on 8 gloo
ranks (tests/torch_dist_workers.py) the tiny preset at 2 layers, packed
and fused, served by the Engine sharded at fsdp 2 x tp 2 (and dp 2), its
speculative decoding (draft 3), and MultiHostEngine at dcn 2 x fsdp 2 x
tp 2 with dcn_role="tp" submitted from rank 0 only, each generates the
greedy tokens of the port's unsharded Engine and of mxq_tpu's (the
oracles of tests/test_sharding.py:106,139 and tests/test_multihost.py:99).
Every rank holds the same logits bit for bit. The same runs with the
ranks simulated by threads of one process (run_ranks) give the same
tokens."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from mxq_tpu.models import llama as jl
from mxq_tpu.serving import engine as jeng
from mxq_tpu.serving import multihost as jmh
from mxq_tpu_torch import weights
from mxq_tpu_torch.models import llama as tl
from mxq_tpu_torch.parallel import sharding
from mxq_tpu_torch.serving import engine as teng
from mxq_tpu_torch.serving import multihost as mh
from mxq_tpu_torch.serving import spec
from torch_dist_workers import (SERVE_ECFG, SERVE_PROMPT, SPEC_PROMPT,
                                Ranks)
from torch_port_helpers import to_numpy_tree


def _jpacked():
    cfg = jl.LlamaConfig.tiny(num_hidden_layers=2)
    params = jl.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, jl.quantize_params_packed(params, cfg, fuse=True)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The 8 ranks' results, started first; meanwhile the references:
    mxq_tpu's unsharded Engine and the port's, each prompt on its own
    engine as the oracles run them."""
    jcfg, jpacked = _jpacked()
    tree = to_numpy_tree(jpacked)
    ranks = Ranks("sharded_serving", 8, str(tmp_path_factory.mktemp("mh")),
                  dict(packed=tree, mesh=(2, 2, 2), hybrid=(2, 1, 2, 2)))
    want = {}
    for name, prompt, horizon in (("serve", SERVE_PROMPT, 4),
                                  ("spec", SPEC_PROMPT, 8)):
        e = jeng.Engine(jpacked, jcfg, jeng.EngineConfig(
            **dict(SERVE_ECFG, horizon=horizon)))
        r = e.submit(prompt, max_new_tokens=5)
        e.run()
        want[name] = list(map(int, r.generated))
    cfg = tl.LlamaConfig.tiny(num_hidden_layers=2)
    packed = weights.params_from_numpy(tree, "cpu")
    port = {}
    for name, prompt in (("serve", SERVE_PROMPT), ("spec", SPEC_PROMPT)):
        e = teng.Engine(packed, cfg, teng.EngineConfig(**SERVE_ECFG),
                        device="cpu")
        r = e.submit(prompt, max_new_tokens=5)
        e.run()
        port[name] = list(r.generated)
    return {"ranks": ranks.results(), "jax": want, "port": port,
            "packed": packed, "cfg": cfg}


def test_references_agree(served):
    assert served["port"] == served["jax"]


def test_sharded_engine_tokens(served):
    want = served["jax"]["serve"]
    for r in served["ranks"]:
        assert r["engine"] == want
    # qkv's 1024 padded columns over tp 2: 512 a rank; 2 of 4 kv heads
    assert {r["local_qkv_cols"] for r in served["ranks"]} == {512}
    assert {r["local_cache_heads"] for r in served["ranks"]} == {2}


def test_sharded_spec_tokens(served):
    want = served["jax"]["spec"]
    for r in served["ranks"]:
        assert r["spec"] == want
        assert r["spec_rounds"] > 0


def test_multihost_engine_tokens(served):
    want = served["jax"]["serve"]
    for r in served["ranks"]:
        assert r["multihost"] == want
        assert r["multihost_uid"] == 0
        assert r["multihost_prompt"] == SERVE_PROMPT.tolist()
        assert r["multihost_finished"] == 1
        # o_proj's 1024 padded columns over ("dcn", "fsdp"), 4 ranks
        assert r["multihost_local_o_cols"] == 256


@pytest.mark.parametrize("key", ["engine_logits", "multihost_logits"])
def test_logits_same_bits_on_every_rank(served, key):
    first = served["ranks"][0][key]
    assert np.isfinite(first).all()
    for r in served["ranks"][1:]:
        np.testing.assert_array_equal(r[key], first)


@pytest.mark.parametrize("sizes,role", [
    ({"dp": 1, "fsdp": 2, "tp": 2}, None),
    ({"dcn": 2, "dp": 1, "fsdp": 2, "tp": 2}, "tp"),
    ({"dcn": 2, "dp": 1, "fsdp": 2, "tp": 1}, "fsdp")],
    ids=["fsdp2-tp2", "dcn2-fsdp2-tp2-tp", "dcn2-fsdp2-fsdp"])
def test_threaded_ranks_tokens(served, sizes, role):
    """run_ranks: every rank a thread of this process, the collectives'
    arithmetic the same."""
    packed, cfg = served["packed"], served["cfg"]

    def rank(comm):
        e = teng.Engine(packed, cfg, teng.EngineConfig(**SERVE_ECFG),
                        device="cpu")
        mh.shard_engine(e, None, role, comm=comm)
        r = e.submit(SERVE_PROMPT, max_new_tokens=5)
        e.run()
        return list(r.generated)

    got = mh.run_ranks(rank, sizes)
    assert len(got) == int(np.prod(list(sizes.values())))
    assert all(g == served["jax"]["serve"] for g in got)


def test_sharded_logits_near_unsharded(served):
    """One decode step of 2 slots and a 16-token prefill at fsdp 2 x tp 2
    (threads) against the unsharded step: within 1e-5 of max|logit|."""
    packed, cfg = served["packed"], served["cfg"]
    gen = torch.Generator().manual_seed(0)
    hist = (torch.randn((2, 2, 2, 32, 4, 64), generator=gen)
            .to(torch.bfloat16))
    toks = torch.tensor([[5], [9]], dtype=torch.int32)
    pos = torch.tensor([17, 3], dtype=torch.int32)
    ids = torch.randint(0, 512, (1, 16), generator=gen)

    def caches():
        return {"k": hist[0].clone(), "v": hist[1].clone()}

    def prefill(fn, params, c):
        return fn(params, ids, cfg, caches={k: v[:, :1] for k, v in
                                            c.items()},
                  cache_pos=0, mask=tl.causal_mask(16, 32),
                  device="cpu")[0]

    ref = tl.decode_slots(packed, toks, cfg, caches(), pos)
    ref_pf = prefill(tl.forward, packed, caches())

    def rank(comm):
        local, step = mh.sharded_step(packed, cfg, comm)
        c = mh.local_caches(caches(), comm)
        return (step.decode_slots(local, toks, cfg, c, pos),
                prefill(step.forward, local, mh.local_caches(caches(),
                                                             comm)))

    for got, got_pf in mh.run_ranks(rank, {"dp": 1, "fsdp": 2, "tp": 2}):
        assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-5
        assert float((got_pf - ref_pf).abs().max()
                     / ref_pf.abs().max()) <= 1e-5


@pytest.mark.parametrize("dcn_role", [None, "tp", "fsdp"])
def test_kv_cache_spec_equals_reference(dcn_role):
    cfg = tl.LlamaConfig.tiny(num_hidden_layers=1)
    bf16 = tl.init_cache(cfg, 2, 16, device="cpu")
    from mxq_tpu_torch.serving import kvcache
    int8 = kvcache.init_quant_cache(1, 2, 16, 4, 64, device="cpu")
    for caches in (bf16, int8):
        ours = mh.kv_cache_spec(caches, dcn_role)
        theirs = jmh.kv_cache_spec(caches, dcn_role)
        assert set(ours) == set(theirs)
        for k in ours:
            assert P(*ours[k]) == theirs[k], (k, ours[k], theirs[k])


def test_param_specs_shard_packed_on_n_only(served):
    """The packed layout is mxq_tpu's: column linears N over tp, row
    linears N over fsdp (over ("dcn", "fsdp") when dcn carries tp), no
    packed linear split on K."""
    specs = sharding.param_specs(served["packed"], packed=True,
                                 dcn_role="tp")["layers"]
    assert specs["qkv_proj"]["w2"] == (None, None, ("dcn", "tp"))
    assert specs["o_proj"]["w2"] == (None, None, ("dcn", "fsdp"))
    plain = sharding.param_specs(served["packed"], packed=True)["layers"]
    assert plain["gate_up_proj"]["w2"] == (None, None, "tp")
    assert plain["down_proj"]["w2"] == (None, None, "fsdp")


def test_kv_quant_refused(served):
    int8 = teng.EngineConfig(**dict(SERVE_ECFG, kv_quant=True))
    with pytest.raises(ValueError, match="kv_quant"):
        mh.MultiHostEngine(served["packed"], served["cfg"], None, int8,
                           device="cpu")
    # nor may an int8 Engine be sharded, or a sharded step make that cache
    e = teng.Engine(served["packed"], served["cfg"], int8, device="cpu")
    with pytest.raises(ValueError, match="kv_quant"):
        mh.shard_engine(e, None)
    _, step = mh.sharded_step(served["packed"], served["cfg"],
                              mh.Comm({}, {}))
    with pytest.raises(ValueError, match="kv_quant"):
        teng.Engine(served["packed"], served["cfg"], int8, device="cpu",
                    ops=step)


def test_multihost_engine_holds_a_ranks_shards_and_heads(served):
    """Built for one rank of fsdp 2 x tp 2 (its coordinates, no group):
    the Engine holds that rank's N-shards and allocates only its heads of
    the cache, and held_bytes counts exactly those."""
    packed, cfg = served["packed"], served["cfg"]
    sizes = {"dp": 1, "fsdp": 2, "tp": 2}
    e = mh.MultiHostEngine(packed, cfg, None,
                           teng.EngineConfig(**SERVE_ECFG), device="cpu",
                           comm=mh.Comm(sizes, {"dp": 0, "fsdp": 1,
                                                "tp": 1})).engine
    # the column linears' 1024 padded columns over tp: 512 a rank
    assert e.params["layers"]["qkv_proj"].out_features == 512
    assert e.params["layers"]["gate_up_proj"].out_features == 512
    assert e.params["embed_tokens"].shape == (256, 128)
    assert e.params["lm_head"].shape == (128, 256)
    nl, slots, rows = cfg.num_hidden_layers, 2, 32
    assert tuple(e.caches["k"].shape) == (nl, slots, rows, 2, 64)
    held = mh.held_bytes(e.params, e.caches)
    assert held["cache"] == 2 * nl * slots * rows * 2 * 64 * 2
    assert held["dense"] < mh.held_bytes(packed, {})["dense"] // 2


def test_count_launch_is_exact_under_thread_switches():
    """Kernel wrappers count through count_launch: 8 threads adding at
    once, the interpreter switching every microsecond, lose nothing."""
    import sys
    import threading
    from mxq_tpu_torch.ops import count_launch

    def fn():
        pass

    fn.launches = 0

    def body():
        for _ in range(5000):
            count_launch(fn)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=body) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(old)
    assert fn.launches == 40000


def test_without_group_submit_is_engine_submit(served):
    """No process group and no mesh: one rank holding everything; submit
    is Engine.submit."""
    e = mh.MultiHostEngine(served["packed"], served["cfg"], None,
                           teng.EngineConfig(**SERVE_ECFG), device="cpu")
    assert not torch.distributed.is_initialized()
    r = e.submit(SERVE_PROMPT, max_new_tokens=5)
    assert r.uid == 0 and list(r.prompt) == SERVE_PROMPT.tolist()
    e.run()
    assert r.generated == served["jax"]["serve"]
    assert e.stats()["requests_finished"] == 1


def test_run_ranks_collectives_under_thread_switches():
    """16 thread-ranks (more than this host's cores), the interpreter
    switching threads every microsecond: every gather and sum of 100
    rounds holds every rank's contribution in rank order."""
    import sys
    sizes = {"dcn": 2, "fsdp": 2, "tp": 4}

    def rank(comm):
        me = comm.index(("dcn", "fsdp", "tp"))[0]
        for i in range(100):
            t = torch.tensor([float(me * 1000 + i)])
            g = comm.gather(t, ("dcn", "tp"), 0)
            base = comm.index("fsdp")[0] * 4
            want = [float((d * 8 + base + k) * 1000 + i)
                    for d in range(2) for k in range(4)]
            assert g.tolist() == want, (me, i, g.tolist())
            assert comm.sum(t, ("fsdp",)).item() == sum(
                float((comm.coords["dcn"] * 8 + f * 4 + comm.coords["tp"])
                      * 1000 + i) for f in range(2))
        return me

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        assert mh.run_ranks(rank, sizes, timeout=60) == list(range(16))
    finally:
        sys.setswitchinterval(old)


def test_run_ranks_raises_a_ranks_error_without_hanging():
    def rank(comm):
        if comm.coords["tp"] == 1:
            raise ValueError("rank fault")
        return comm.gather(torch.ones(1), "tp", 0)

    with pytest.raises(RuntimeError, match="rank fault"):
        mh.run_ranks(rank, {"tp": 2}, timeout=30)
