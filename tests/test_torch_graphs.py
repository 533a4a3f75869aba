"""The decode chunks' runner (``serving/graphs.py``) on the CPU: the slot
Engine (1 and 4 slots, horizon 1 and 8), the PagedEngine (int8 and bf16
pool) and ``run_spec_pipelined`` run their chunks through its static
inputs and outputs, with every key's outputs overwritten between chunks
(what a replay on the card does to them), and their greedy tokens equal
``mxq_tpu``'s on the tiny packed model. A reader that held a chunk's
outputs across the next chunk gets wrong tokens under the same poisoning.
With the CUDA calls stood in for, the runner's launch accounting: the
warm-up and the capture count nothing, each replay adds the captured
launches; and the attention tickets refuse to grow during a capture."""

import contextlib

import jax
import numpy as np
import pytest
import torch

from mxq_tpu.models import llama as jl
from mxq_tpu.serving import engine as jeng
from mxq_tpu.serving import paged as jpg
from mxq_tpu.serving import spec as jspec
from mxq_tpu_torch.models import llama as tl
from mxq_tpu_torch.ops import attn_int8 as a8
from mxq_tpu_torch.ops import count_launch
from mxq_tpu_torch.serving import engine as teng
from mxq_tpu_torch.serving import graphs
from mxq_tpu_torch.serving import paged as tpg
from mxq_tpu_torch.serving import spec as tspec
from torch_port_helpers import port_params

TCFG = tl.LlamaConfig.tiny()
POISON = -7
# slots -> requests (prompt, new tokens): continuous batching through 4
# slots, three requests one after another through 1
RNG = np.random.RandomState(17)
REQS = {4: [(RNG.randint(1, 512, n).astype(np.int32), k)
            for n, k in ((5, 6), (9, 9), (3, 4), (12, 7), (7, 10), (4, 5))],
        1: [(RNG.randint(1, 512, n).astype(np.int32), k)
            for n, k in ((6, 5), (11, 9), (4, 3))]}
SLOT_CASES = [(slots, h) for slots in (4, 1) for h in (1, 8)]
PAGED_REQS = [(RNG.randint(1, 512, n).astype(np.int32), k)
              for n, k in ((40, 6), (9, 9), (20, 4), (70, 7))]
SPEC_PROMPTS = [np.array([4, 5, 6] * 5, np.int32),
                RNG.randint(1, 512, 12).astype(np.int32)]


def _slot(mod, params, cfg, slots, horizon, **kw):
    e = mod.Engine(params, cfg, mod.EngineConfig(
        num_slots=slots, max_len=64, prefill_buckets=(16,), kv_quant=True,
        horizon=horizon), **kw)
    reqs = [e.submit(p, max_new_tokens=n) for p, n in REQS[slots]]
    if horizon == 1:
        while len([r for r in reqs if r.done]) < len(reqs):
            e.step()
    else:
        assert len(e.run()) == len(reqs)
    return [list(map(int, r.generated)) for r in reqs]


def _paged(mod, params, cfg, kv_bits, **kw):
    e = mod.PagedEngine(params, cfg, num_slots=2, total_pages=40,
                        page_size=16, max_len=256, prefill_bucket=64,
                        kv_bits=kv_bits, **kw)
    reqs = [e.submit(p, max_new_tokens=n) for p, n in PAGED_REQS]
    assert len(e.run()) == len(reqs)
    return [list(map(int, r.generated)) for r in reqs]


def _spec(mod, spec_mod, params, cfg, **kw):
    e = mod.Engine(params, cfg, mod.EngineConfig(
        num_slots=2, max_len=64, prefill_buckets=(16,), kv_quant=True), **kw)
    reqs = [e.submit(p, max_new_tokens=8) for p in SPEC_PROMPTS]
    spec_mod.run_spec_pipelined(e, draft_len=4, rounds=2, auto_disable=False)
    return [list(map(int, r.generated)) for r in reqs], e


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX tiny packed model and its engine runs — one fixture,
    because the JAX engines on the CPU take tens of seconds."""
    cfg = jl.LlamaConfig.tiny()
    jp = jl.quantize_params_packed(jl.init_params(cfg, jax.random.PRNGKey(0)),
                                   cfg)
    want = {("slot",) + c: _slot(jeng, jp, cfg, *c) for c in SLOT_CASES}
    want.update({("paged", kv): _paged(jpg, jp, cfg, kv) for kv in (32, 8)})
    want["spec"] = _spec(jeng, jspec, jp, cfg)[0]
    return port_params(jp), want


@pytest.fixture
def poisoned(monkeypatch):
    """Every run of a ChunkRunner first overwrites the static outputs of
    all its keys with POISON; returns the runners seen."""
    run, seen = graphs.ChunkRunner.run, []

    def poisoning(self, key, fn):
        if self not in seen:
            seen.append(self)
        for c in self._chunks.values():
            outs = [c.outputs] if isinstance(c.outputs, torch.Tensor) \
                else list(c.outputs or ())
            while outs:
                t = outs.pop()
                if isinstance(t, torch.Tensor):
                    t.fill_(POISON)
                else:
                    outs += list(t)
        return run(self, key, fn)

    monkeypatch.setattr(graphs.ChunkRunner, "run", poisoning)
    return seen


@pytest.mark.parametrize("slots,horizon", SLOT_CASES)
def test_slot_engine_through_static_buffers_equals_jax(jax_runs, poisoned,
                                                       slots, horizon):
    tp, want = jax_runs
    got = _slot(teng, tp, TCFG, slots, horizon, device="cpu")
    assert got == want[("slot", slots, horizon)]
    (runner,) = poisoned
    assert set(runner._chunks) == {("decode", horizon)}


@pytest.mark.parametrize("kv_bits", [8, 32])
def test_paged_engine_through_static_buffers_equals_jax(jax_runs, poisoned,
                                                        kv_bits):
    tp, want = jax_runs
    assert _paged(tpg, tp, TCFG, kv_bits, device="cpu") \
        == want[("paged", kv_bits)]
    (runner,) = poisoned
    assert set(runner._chunks) == {("decode", tpg.HORIZON)}


def test_spec_pipelined_through_static_buffers_equals_jax(jax_runs,
                                                          poisoned):
    tp, want = jax_runs
    got, e = _spec(teng, tspec, tp, TCFG, device="cpu")
    assert got == want["spec"]
    # the state chained from chunk to chunk went through the runner
    assert ("spec", 4, 2, 3) in e._graphs._chunks


def test_reader_holding_outputs_across_a_chunk_gets_poison(
        jax_runs, poisoned, monkeypatch):
    """The token copy made lazily (a reference to the static outputs, read
    after the next chunk ran): the poisoning turns its tokens wrong."""
    tp, want = jax_runs

    def holding(self, t):
        self._host, self._event = t, None
    monkeypatch.setattr(teng._HostCopy, "__init__", holding)
    assert _slot(teng, tp, TCFG, 4, 8, device="cpu") \
        != want[("slot", 4, 8)]


def test_static_outputs_are_overwritten_by_every_run():
    r = graphs.ChunkRunner(torch.device("cpu"))
    ins = r.stage("a", x=np.arange(3, dtype=np.int32))
    out = r.run("a", lambda x: (x + 1, x * 2))
    first = [t.clone() for t in out]
    ins["x"][0] = 10                    # written before the run, as dispatch does
    again = r.run("a", lambda x: (x + 1, x * 2))
    assert again is out and out[0].tolist() == [11, 2, 3]
    assert first[0].tolist() == [1, 2, 3]
    r.stage("a", x=torch.full((3,), 5, dtype=torch.int32))
    assert r.run("a", lambda x: (x + 1, x * 2))[1].tolist() == [10] * 3
    with pytest.raises(ValueError, match="made as torch.int32"):
        r.stage("a", x=np.arange(4, dtype=np.int32))
    # the eager path returns the call's own results
    assert r.eager("a", lambda x: x)[0] == 5


class _FakeGraph:
    def __init__(self):
        self.generators, self.replays = [], 0

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def replay(self):
        self.replays += 1


@pytest.fixture
def fake_cuda(monkeypatch):
    """The CUDA calls of ChunkRunner's capture stood in for on the CPU; a
    fake kernel wrapper with a launch counter in place of the port's."""
    class Stream:
        def wait_stream(self, other):
            pass

    def wrapper():
        count_launch(wrapper)
    wrapper.launches = 0

    def idle():
        pass
    idle.launches = 0
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, pool, stream: contextlib.nullcontext())
    monkeypatch.setattr(graphs, "kernel_wrappers", lambda: [wrapper, idle])
    return wrapper, idle


def test_replays_add_the_captured_launches(fake_cuda):
    wrapper, idle = fake_cuda
    wrapper.launches = 5                # launches of earlier work
    gen = torch.Generator().manual_seed(3)
    r = graphs.ChunkRunner(torch.device("cuda"), gen)
    drawn = []

    def chunk():
        for _ in range(3):
            wrapper()
        drawn.append(torch.rand(2, generator=gen))
        return torch.zeros(2)

    state = gen.get_state()
    r.stage("k")
    r.run("k", chunk)                   # warm-up, capture, one replay
    assert len(drawn) == 2              # the warm-up and the capture ran it
    assert wrapper.launches == 5 + 3 and idle.launches == 0
    assert torch.equal(gen.get_state(), state)    # no draw moved the stream
    graph = r._chunks["k"].graph
    assert graph.generators == [gen] and graph.replays == 1
    for _ in range(2):
        r.run("k", chunk)
    assert len(drawn) == 2 and graph.replays == 3
    assert wrapper.launches == 5 + 9 and idle.launches == 0
    assert r.captures == {"k": 1} and r.replays == {"k": 3}


def test_tickets_do_not_grow_during_a_capture(monkeypatch):
    cpu = torch.device("cpu")
    monkeypatch.setattr(a8, "_TICKETS", {})
    monkeypatch.setattr(a8, "_RETIRED", [])
    held = a8.reserve_tickets(8, cpu)
    monkeypatch.setattr(a8, "_capturing", lambda device: True)
    _, tickets = a8._split_scratch(2, 4, 1, 2, 64, cpu)       # 8 pairs
    assert tickets is held
    with pytest.raises(RuntimeError, match="reserve them before"):
        a8._split_scratch(3, 4, 1, 2, 64, cpu)
    monkeypatch.setattr(a8, "_capturing", lambda device: False)
    _, grown = a8._split_scratch(3, 4, 1, 2, 64, cpu)
    # outgrown outside a capture: a new zeroed buffer, the old one kept
    # alive for the graphs that hold it
    assert grown.numel() == 12 and not grown.any()
    assert a8._RETIRED == [held]


def test_kernel_wrappers_once_each():
    """The launch accounting walks every kernel wrapper once: K4a/K4c and
    K4b/K4d share a wrapper, which must not add its launches twice."""
    from mxq_tpu_torch.ops import attn_bf16 as ab
    from mxq_tpu_torch.ops import mxq_matmul as mm
    from mxq_tpu_torch.ops import uniform4 as u4
    ws = graphs.kernel_wrappers()
    assert len(ws) == len(set(ws))
    assert set(ws) == {f for m in (mm, a8, u4, ab)
                       for f in m.KERNELS.values()}
