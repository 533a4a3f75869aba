"""The port's C++ runtime (mxq_tpu_torch/runtime/native.py, built with g++
into mxq_tpu_torch/_build/) against mxq_tpu's: the packers equal
mxq_tpu.runtime.native's and the port's packfmt words, the scheduler's
lifecycle and EOS tests of tests/test_native.py, and on random streams the
native scheduler's decisions equal the plain Python scheduler's. The
Engine schedules through the native one, and a failed build raises."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp

from mxq_tpu import packfmt as jpackfmt
from mxq_tpu.runtime import native as jnative
from mxq_tpu_torch import packfmt
from mxq_tpu_torch._build import BUILD_DIR
from mxq_tpu_torch.models import llama
from mxq_tpu_torch.runtime import native
from mxq_tpu_torch.serving import engine as eng
import torch_port_helpers  # noqa: F401  (one torch thread per process)


def test_library_builds_into_build_dir():
    lib = native.get_lib()
    assert native.LIB_PATH.parent == BUILD_DIR
    assert native.LIB_PATH.exists()
    assert native.LIB_PATH.stat().st_mtime >= native.SRC.stat().st_mtime
    assert lib.mxq_sched_new is not None


@pytest.mark.parametrize("bits,seed,shape", [(2, 0, (768, 256)),
                                             (4, 1, (256, 256))])
def test_pack_words_equal_reference(bits, seed, shape):
    codes = np.random.RandomState(seed).randint(0, 2**bits, shape).astype(
        np.int8)
    ours = {2: native.pack2b, 4: native.pack4b}[bits]
    plain = {2: native.pack2b_plain, 4: native.pack4b_plain}[bits]
    theirs = {2: jnative.pack2b, 4: jnative.pack4b}[bits]
    out = ours(codes)
    np.testing.assert_array_equal(out, theirs(codes))
    np.testing.assert_array_equal(out, plain(codes))
    np.testing.assert_array_equal(out, np.asarray(
        jpackfmt._pack_along_sublanes(jnp.asarray(codes), bits)))
    np.testing.assert_array_equal(out, packfmt._pack_along_sublanes(
        torch.from_numpy(codes), bits).numpy())
    if bits == 2:
        np.testing.assert_array_equal(native.unpack2b(out), codes)
        np.testing.assert_array_equal(native.unpack2b_plain(out), codes)
        np.testing.assert_array_equal(native.unpack2b(out),
                                      jnative.unpack2b(out))


def test_pack_meta_reproduces_packer_meta():
    """The meta packer re-packs quantize_pack's meta2 (JAX's and the
    port's, which are equal) from its group-indexed zero/scale codes."""
    w = np.array(jax.random.normal(jax.random.PRNGKey(0), (256, 1024),
                                    jnp.float32))
    meta = np.asarray(jpackfmt.quantize_pack(jnp.asarray(w)).meta2)
    np.testing.assert_array_equal(
        packfmt.quantize_pack(torch.from_numpy(w)).meta2.numpy(), meta)
    n = meta.shape[1]
    zc = np.zeros((48, n), np.int8)
    sc = np.zeros((48, n), np.int8)
    for r in range(16):
        for i in range(3):
            zc[16 * i + r] = (meta[r] >> (2 * i)) & 3
            sc[16 * i + r] = (meta[r] >> (6 + 8 * i)) & 255
    out = native.pack_meta(zc, sc)
    np.testing.assert_array_equal(out, meta)
    np.testing.assert_array_equal(native.pack_meta_plain(zc, sc), meta)
    np.testing.assert_array_equal(jnative.pack_meta(zc, sc), meta)


@pytest.mark.parametrize("cls", [native.NativeScheduler, eng._PyScheduler,
                                 jnative.NativeScheduler],
                         ids=["native", "plain", "mxq_tpu"])
def test_scheduler_lifecycle(cls):
    s = cls(num_slots=2, max_len=64)
    for uid in range(5):
        s.submit(uid, prompt_len=4, max_new_tokens=3)
    assert s.pending == 5
    admitted = s.admit()
    assert [a[0] for a in admitted] == [0, 1]
    assert s.pending == 3
    for slot, uid, plen in admitted:
        for t in range(3):
            assert s.on_token(slot, token=7) == (t == 2)
    assert s.completed == 2
    admitted = s.admit()
    assert len(admitted) == 2 and s.pending == 1


@pytest.mark.parametrize("cls", [native.NativeScheduler, eng._PyScheduler,
                                 jnative.NativeScheduler],
                         ids=["native", "plain", "mxq_tpu"])
def test_scheduler_eos_stops_early(cls):
    s = cls(num_slots=1, max_len=64)
    s.submit(0, prompt_len=2, max_new_tokens=10, eos_token=9)
    s.admit()
    assert not s.on_token(0, 5)
    assert s.on_token(0, 9)
    assert s.completed == 1


def test_scheduler_cache_full_and_cancel():
    """Retirement at position max_len - 1 and the three cancel results,
    native against plain against mxq_tpu's."""
    ops = [("submit", 0, 5, 100, -1), ("submit", 1, 2, 100, -1),
           ("submit", 2, 2, 100, -1), ("admit",), ("cancel", 2),
           ("cancel", 1), ("cancel", 7)] + [("token", 0, 3)] * 4
    runs = [native.replay(cls(2, 8), ops) for cls in (
        native.NativeScheduler, eng._PyScheduler, jnative.NativeScheduler)]
    assert runs[0] == runs[1] == runs[2]
    assert [r[1] for r in runs[0] if r[0] == "cancel"] == [-1, 1, -2]
    # position 5 + 2 reaches max_len - 1 at the third token; the fourth
    # finds no occupied slot
    assert [r[1] for r in runs[0] if r[0] == "token"] == [False, False,
                                                          True]


_op = st.one_of(
    st.tuples(st.just("submit"), st.integers(1, 60), st.integers(1, 12),
              st.integers(-1, 4)),
    st.tuples(st.just("admit")),
    st.tuples(st.just("token"), st.integers(0, 16), st.integers(0, 4)),
    st.tuples(st.just("cancel"), st.integers(0, 40)))


@settings(max_examples=60, deadline=None)
@given(ops=st.lists(_op, max_size=120), slots=st.integers(1, 4),
       max_len=st.integers(2, 64))
def test_native_and_plain_schedulers_agree(ops, slots, max_len):
    """Every admission, retirement, cancel result, pending and completed
    count of a random stream (uids numbered in submit order)."""
    stream, uid = [], 0
    for op in ops:
        if op[0] == "submit":
            stream.append(("submit", uid) + op[1:])
            uid += 1
        else:
            stream.append(op)
    assert (native.replay(native.NativeScheduler(slots, max_len), stream)
            == native.replay(eng._PyScheduler(slots, max_len), stream))


def test_seeded_random_stream_agrees():
    """random_ops' stream, as the card's serve phase replays it at 8 slots
    and max_len 2048."""
    ops = native.random_ops(np.random.default_rng(0), 2000, 2048)
    got = native.replay(native.NativeScheduler(8, 2048), ops)
    assert got == native.replay(eng._PyScheduler(8, 2048), ops)
    kinds = {r[0] for r in got}
    assert kinds == {"submit", "admit", "token", "cancel"}
    assert got[-1][3] > 0


def test_missing_compiler_raises(tmp_path):
    with pytest.raises(RuntimeError, match="not found"):
        native.build(tmp_path / "libmxq_runtime.so",
                     cxx=str(tmp_path / "no-such-g++"))
    assert not (tmp_path / "libmxq_runtime.so").exists()


def test_failed_compile_raises_with_stderr(tmp_path):
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\necho 'error: broken toolchain' >&2\nexit 1\n")
    cxx.chmod(0o755)
    with pytest.raises(RuntimeError, match="broken toolchain"):
        native.build(tmp_path / "lib.so", cxx=str(cxx), force=True)
    assert list(tmp_path.iterdir()) == [cxx]


def test_engine_schedules_natively():
    cfg = llama.LlamaConfig.tiny(num_hidden_layers=1)
    params = llama.init_params(cfg, 0, device="cpu")
    e = eng.Engine(params, cfg, eng.EngineConfig(
        num_slots=2, max_len=32, prefill_buckets=(8,), kv_quant=False,
        horizon=2), device="cpu")
    assert isinstance(e._sched, native.NativeScheduler)
    reqs = [e.submit(np.arange(3, dtype=np.int32) + i, max_new_tokens=3)
            for i in range(3)]
    e.run()
    assert [len(r.generated) for r in reqs] == [3, 3, 3]
    assert e._sched.completed == 3 and e._sched.pending == 0
