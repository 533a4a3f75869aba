"""Continuous-batching slot engine (port of ``mxq_tpu/serving/engine.py``).

A fixed number of sequence slots share one static KV cache. Finished
sequences free their slot; queued requests prefill into free slots while
the others keep decoding. Device work:

  * prefill of one slot's prompt in padded buckets (chunked past the largest);
  * decode chunks of ``horizon`` steps for every slot at once, each slot
    writing its KV at its own position.

The run loop is pipelined: chunk k+1 is dispatched before chunk k's tokens
are read, its input tokens chained on the device from chunk k's output.
Tokens reach the host through non-blocking copies into pinned memory,
each with a CUDA event, so reading chunk k never waits for chunk k+1.
Sampling draws from a ``torch.Generator`` seeded with ``EngineConfig.seed``.
The host scheduler is the Python one (the C++ scheduler is not ported).
Prompt-lookup speculative decoding drives the same engine from
``serving/spec.py`` through :meth:`Engine._verify`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from mxq_tpu_torch import resolve_device
from mxq_tpu_torch.models import llama
from mxq_tpu_torch.ops import uniform4
from mxq_tpu_torch.scheme import div_const
from mxq_tpu_torch.serving import kvcache

NEG = torch.finfo(torch.float32).min


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                  # [T] int32
    max_new_tokens: int = 64
    eos_token_id: Optional[int] = None
    # filled by the engine:
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    # host-clock observability (seconds, time.monotonic):
    t_submit: float = 0.0
    t_first: float = 0.0                # first token observed (TTFT anchor)
    t_done: float = 0.0


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    num_slots: int = 8
    max_len: int = 2048
    prefill_buckets: tuple = (128, 512, 2048)
    kv_quant: bool = True               # int8 KV cache
    greedy: bool = True
    temperature: float = 1.0
    top_k: int = 0                      # 0 = no top-k filter
    top_p: float = 1.0                  # 1.0 = no nucleus filter
    seed: int = 0
    horizon: int = 8                    # decode steps per dispatch
    prefill_a8: bool = False            # int8-activation prefill (K5)
    lm_head_bits: int = 16              # 4: uniform-4b packed lm_head (K7)


def filter_logits(logits: torch.Tensor, temperature: float, top_k: int,
                  top_p: float) -> torch.Tensor:
    """[B, V] logits scaled by the temperature, with the tokens outside the
    top-k / nucleus set to the most negative float."""
    lg = div_const(logits.float(), max(temperature, 1e-6))
    if top_k > 0:
        kth = torch.topk(lg, top_k, dim=-1).values[:, -1:]
        lg = torch.where(lg < kth, NEG, lg)
    if top_p < 1.0:
        srt = torch.sort(lg, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        csum = torch.cumsum(probs, dim=-1)
        keep = (csum - probs) < top_p     # exclusive prefix mass < top_p
        cutoff = torch.where(keep, srt, torch.inf).amin(dim=-1, keepdim=True)
        lg = torch.where(lg < cutoff, NEG, lg)
    return lg


def sample_token(logits: torch.Tensor, generator: torch.Generator,
                 greedy: bool, temperature: float, top_k: int,
                 top_p: float) -> torch.Tensor:
    """Next token [B] int32 from [B, V] logits: argmax when greedy (or
    top_k == 1), else a draw from the filtered distribution."""
    if greedy or top_k == 1:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(filter_logits(logits, temperature, top_k, top_p),
                          dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


class _PyScheduler:
    """Slot admission and per-token retirement on EOS / max_new_tokens /
    cache-full (the semantics of ``mxq_tpu``'s C++ scheduler)."""

    def __init__(self, num_slots: int, max_len: int):
        self.num_slots, self.max_len = num_slots, max_len
        self._slot = [None] * num_slots     # per-slot dict or None
        self._pos = [0] * num_slots
        self._queue: list[dict] = []
        self.completed = 0

    def submit(self, uid, prompt_len, max_new_tokens, eos_token=-1):
        self._queue.append(dict(uid=uid, plen=prompt_len,
                                max_new=max_new_tokens, eos=eos_token,
                                generated=0))

    def admit(self):
        out = []
        for i in range(self.num_slots):
            if self._slot[i] is not None or not self._queue:
                continue
            r = self._queue.pop(0)
            self._slot[i] = r
            self._pos[i] = r["plen"]
            out.append((i, r["uid"], r["plen"]))
        return out

    def on_token(self, slot: int, token: int) -> bool:
        r = self._slot[slot]
        r["generated"] += 1
        if r["generated"] > 1:          # first token came from prefill
            self._pos[slot] += 1
        hit_eos = r["eos"] >= 0 and token == r["eos"]
        full = self._pos[slot] >= self.max_len - 1
        if r["generated"] >= r["max_new"] or hit_eos or full:
            self._slot[slot] = None
            self.completed += 1
            return True
        return False

    def cancel(self, uid: int) -> int:
        """Cancel by uid: freed slot index, -1 if dequeued, -2 if unknown."""
        for i in range(self.num_slots):
            if self._slot[i] is not None and self._slot[i]["uid"] == uid:
                self._slot[i] = None
                return i
        for j, r in enumerate(self._queue):
            if r["uid"] == uid:
                del self._queue[j]
                return -1
        return -2

    @property
    def pending(self) -> int:
        return len(self._queue)


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor without waiting for queued work (the
    array is copied into pinned memory first, so the host may change it
    right after)."""
    t = torch.from_numpy(np.array(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class _HostCopy:
    """A device tensor on its way to the host: a non-blocking copy into
    pinned memory and an event, so reading it waits for this copy only."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = t, None

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class Engine:
    """Single-device continuous-batching engine over a (packed) model."""

    def __init__(self, params, cfg: llama.LlamaConfig,
                 ecfg: EngineConfig = EngineConfig(),
                 device: str | torch.device = "cuda"):
        self.device = dev = resolve_device(device)
        llama.check_params_device(params, dev)
        head = params.get("lm_head")
        if ecfg.lm_head_bits == 4 and isinstance(head, torch.Tensor):
            # the head is stored [hidden, vocab]; the packer takes [O, K]
            params = dict(params, lm_head=uniform4.quantize_pack_u4(head.T))
        if ecfg.prefill_a8:
            cfg = dataclasses.replace(cfg, prefill_act_bits=8)
        self.params = params
        self.cfg = cfg
        buckets = tuple(b for b in sorted(ecfg.prefill_buckets)
                        if b <= ecfg.max_len) or (ecfg.max_len,)
        ecfg = dataclasses.replace(ecfg, prefill_buckets=buckets)
        self.ecfg = ecfg
        nl, b = cfg.num_hidden_layers, ecfg.num_slots
        if ecfg.kv_quant:
            self.caches = kvcache.init_quant_cache(
                nl, b, ecfg.max_len, cfg.num_key_value_heads, cfg.head_dim,
                device=dev)
        else:
            self.caches = llama.init_cache(cfg, b, ecfg.max_len, device=dev)
        self._sched = _PyScheduler(b, ecfg.max_len)
        self._reqs: dict[int, Request] = {}
        self._slot_uid: list[Optional[int]] = [None] * b
        self._pos = np.zeros(b, np.int32)        # dispatch-time write position
        self._last_tok = np.zeros(b, np.int32)   # host-known last token/slot
        self._admit_gen = np.zeros(b, np.int64)  # bumps on each admission
        self._inflight = None
        self._uid = 0
        self._pending_first = {}                 # slot -> (device, _HostCopy)
        self._stream_buf = None                  # set by stream()
        self._gen = torch.Generator(device=dev).manual_seed(ecfg.seed)
        # speculative-decoding accounting (filled by serving/spec.py):
        # rounds = verify rounds, accepted = tokens emitted, dispatches =
        # spec chunks (run_spec: verify steps) sent to the device
        self._spec_stats = {"rounds": 0, "accepted": 0, "dispatches": 0}

    # ---- device work ----

    def _pick(self, logits: torch.Tensor) -> torch.Tensor:
        e = self.ecfg
        return sample_token(logits, self._gen, e.greedy, e.temperature,
                            e.top_k, e.top_p)

    def _decode_chunk(self, chained, host_toks, use_chain, positions, active,
                      horizon: int) -> torch.Tensor:
        """``horizon`` decode steps for all slots; returns tokens
        [horizon, B] on the device. ``chained`` [B] is the previous chunk's
        last token (never fetched); ``host_toks`` overrides it where
        ``use_chain`` is False (freshly admitted slots)."""
        toks = torch.where(use_chain, chained, host_toks)[:, None]
        max_len = self.ecfg.max_len
        out = []
        for i in range(horizon):
            # NEAR-CAPACITY CLAMP: a slot admitted at plen = max_len-1 gets
            # `horizon` steps with a fixed active mask, so later steps would
            # write KV at positions >= max_len — past the cache and past
            # K4's invariant (S > max(positions)). Clamp the write row to the
            # last one (the slot is retired by host bookkeeping after its
            # real last token, so the re-written row is never read) and zero
            # the overflow steps' tokens like inactive slots'.
            in_range = positions + i < max_len
            pos_i = torch.where(in_range, positions + i,
                                max_len - 1).to(torch.int32)
            logits = llama.decode_slots(self.params, toks, self.cfg,
                                        self.caches, pos_i)
            nxt = self._pick(logits[:, -1])
            nxt = torch.where(active & in_range, nxt, 0).to(torch.int32)
            out.append(nxt)
            toks = nxt[:, None]
        return torch.stack(out)

    def _prefill(self, ids: np.ndarray, length: int, offset: int,
                 slot: int) -> torch.Tensor:
        """Prefill one slot's window of ``length`` real tokens (padded to
        the bucket) at cache rows ``offset..``; the queries attend every row
        below ``offset`` plus the causal prefix of their own window. Writes
        the slot's cache rows in place; returns its next token (device)."""
        sl = {k: v[:, slot:slot + 1] for k, v in self.caches.items()}
        t = ids.shape[1]
        s = llama._cache_len(sl)
        qpos = offset + torch.arange(t, device=self.device)[:, None]
        kpos = torch.arange(s, device=self.device)[None, :]
        mask = torch.where((kpos <= qpos) & (kpos < offset + length), 0.0,
                           NEG)
        logits, _ = llama.forward(self.params, to_device(ids, self.device),
                                  self.cfg, caches=sl, cache_pos=offset,
                                  mask=mask[None, None], device=self.device)
        return self._pick(logits[0:1, length - 1])[0]

    def _verify(self, toks: torch.Tensor, positions: torch.Tensor,
                active: torch.Tensor) -> torch.Tensor:
        """One speculative verify step: tokens [B, T] written at rows
        positions[b] + t of every slot's cache; returns the greedy
        predictions [B, T] int32 (0 for inactive slots). Stays on the
        device."""
        logits = llama.decode_slots(self.params, toks, self.cfg, self.caches,
                                    positions)
        preds = torch.argmax(logits, dim=-1).to(torch.int32)
        return torch.where(active[:, None], preds, 0).to(torch.int32)

    # ---- host-side scheduling + pipelined dispatch ----

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 64,
               eos_token_id: Optional[int] = None) -> Request:
        req = Request(self._uid, np.asarray(prompt, np.int32), max_new_tokens,
                      eos_token_id, t_submit=time.monotonic())
        self._uid += 1
        self._reqs[req.uid] = req
        # Prompts longer than the largest bucket prefill in chunks; only
        # prompts that cannot fit the cache keep their LAST max_len-1 tokens.
        plen = min(len(req.prompt), self.ecfg.max_len - 1)
        self._sched.submit(req.uid, plen, max_new_tokens,
                           -1 if eos_token_id is None else eos_token_id)
        return req

    def stats(self) -> dict:
        """TTFT and end-to-end latency percentiles and generated-token
        throughput over all requests seen (host clock; with the pipelined
        loop, token observation lags the device by up to one chunk)."""
        fin = [r for r in self._reqs.values()
               if r.done and r.t_first and r.t_done]
        out = {"requests_submitted": len(self._reqs),
               "requests_finished": len(fin),
               "tokens_generated": sum(len(r.generated)
                                       for r in self._reqs.values())}
        if fin:
            ttft = np.array([r.t_first - r.t_submit for r in fin])
            e2e = np.array([r.t_done - r.t_submit for r in fin])
            span = (max(r.t_done for r in fin)
                    - min(r.t_submit for r in fin)) or 1e-9
            out.update(
                ttft_p50_s=float(np.percentile(ttft, 50)),
                ttft_p95_s=float(np.percentile(ttft, 95)),
                e2e_p50_s=float(np.percentile(e2e, 50)),
                e2e_p95_s=float(np.percentile(e2e, 95)),
                tokens_per_sec=sum(len(r.generated) for r in fin) / span)
        st = self._spec_stats
        if st["rounds"]:
            out.update(
                spec_verify_rounds=st["rounds"],
                spec_dispatches=st["dispatches"],
                # tokens yielded per verify round (1 = no draft accepted;
                # draft_len + 1 = full acceptance)
                spec_accept_len_mean=st["accepted"] / st["rounds"],
                spec_tokens_per_dispatch=(st["accepted"]
                                          / max(st["dispatches"], 1)))
        if "accept_ema" in st:
            # the auto-disable's acceptance EMA and plain-chunk count
            # (spec.run_spec_pipelined), even before a verify round ran
            out["spec_accept_ema"] = float(st["accept_ema"])
            out["spec_plain_chunks"] = int(st.get("plain_chunks", 0))
        return out

    def cancel(self, req: "Request | int") -> bool:
        """Cancel a queued or running request. A running request frees its
        slot at once; tokens already in flight for it are dropped when
        their chunk is read (uid guard). False if it already finished."""
        uid = req.uid if isinstance(req, Request) else int(req)
        slot = self._sched.cancel(uid)
        if slot == -2:
            return False
        if slot >= 0:
            self._pending_first.pop(slot, None)
            if self._slot_uid[slot] == uid:
                self._slot_uid[slot] = None
        r = self._reqs.get(uid)
        if r is not None:
            r.done = True
            if not r.t_done:
                r.t_done = time.monotonic()
        return True

    def _admit(self, finished: list) -> None:
        """Admit queued requests into free slots (prefill per slot)."""
        for slot, uid, plen in self._sched.admit():
            req = self._reqs[uid]
            bmax = self.ecfg.prefill_buckets[-1]
            tail = req.prompt[-(self.ecfg.max_len - 1):]
            t = len(tail)
            first = None
            for off in range(0, t, bmax):
                ts = len(tail[off:off + bmax])
                bucket = next((bkt for bkt in self.ecfg.prefill_buckets
                               if bkt >= ts), bmax)
                # the padded window must fit the cache: shift it left rather
                # than let it overrun (the overlap rows recompute identical
                # KV from the same tokens and positions)
                w = min(off, self.ecfg.max_len - bucket)
                sub = tail[w:w + bucket]
                ts = len(sub)
                ids = np.zeros((1, bucket), np.int32)
                ids[0, :ts] = sub
                first = self._prefill(ids, ts, w, slot)
            # deferred first-token fetch: it chains into the next decode
            # chunk on the device, and its host copy is read after that
            # chunk is dispatched
            self._pending_first[slot] = (first, _HostCopy(first))
            req.generated = []
            self._slot_uid[slot] = uid
            self._pos[slot] = t
            self._admit_gen[slot] += 1

    def _active_mask(self) -> np.ndarray:
        return np.array([u is not None for u in self._slot_uid])

    def _dispatch(self, horizon: int):
        """Launch one decode chunk (no fetch). Input tokens chain on the
        device from the in-flight chunk where valid, else come from the
        host."""
        active = self._active_mask()
        if not active.any():
            return None
        b = self.ecfg.num_slots
        if self._inflight is not None:
            fl = self._inflight
            chained = fl["toks"][-1]
            use_chain = (fl["active"] & active
                         & (fl["gen"] == self._admit_gen))
        else:
            chained = torch.zeros((b,), dtype=torch.int32, device=self.device)
            use_chain = np.zeros(b, bool)
        host_toks = to_device(self._last_tok, self.device)
        for s, (fd, _) in self._pending_first.items():
            if self._slot_uid[s] is not None:
                host_toks[s] = fd                    # device to device
        toks = self._decode_chunk(
            chained, host_toks, to_device(use_chain, self.device),
            to_device(self._pos, self.device),
            to_device(active, self.device), horizon)
        snap = dict(toks=toks, host=_HostCopy(toks), active=active,
                    gen=self._admit_gen.copy(), uids=list(self._slot_uid),
                    horizon=horizon)
        self._pos[active] += horizon
        return snap

    def _flush_pending_first(self, finished: list) -> None:
        """Read deferred prefill first-tokens and run their bookkeeping
        (before the chunk tokens of the same slots are processed)."""
        for s in list(self._pending_first):
            _, hc = self._pending_first.pop(s)
            uid = self._slot_uid[s]
            if uid is None:
                continue
            first = int(hc.numpy())
            req = self._reqs[uid]
            req.generated.append(first)
            if self._stream_buf is not None:
                self._stream_buf.append((req, first))
            if not req.t_first:
                req.t_first = time.monotonic()
            self._last_tok[s] = first
            if self._sched.on_token(s, first):
                req.done = True
                req.t_done = req.t_first
                finished.append(req)
                self._slot_uid[s] = None

    def _process_inflight(self) -> list[Request]:
        """Read the in-flight chunk's tokens and run retire/admit
        bookkeeping through the scheduler."""
        fl = self._inflight
        self._inflight = None
        finished: list[Request] = []
        self._flush_pending_first(finished)
        toks = fl["host"].numpy()               # [horizon, B]; waits
        now = time.monotonic()
        retired = set()
        for i in range(fl["horizon"]):
            for s in np.where(fl["active"])[0]:
                uid = fl["uids"][s]
                if s in retired or uid is None or self._slot_uid[s] != uid:
                    continue
                tok = int(toks[i, s])
                req = self._reqs[uid]
                req.generated.append(tok)
                if self._stream_buf is not None:
                    self._stream_buf.append((req, tok))
                if not req.t_first:
                    req.t_first = now
                self._last_tok[s] = tok
                if self._sched.on_token(s, tok):
                    req.done = True
                    req.t_done = now
                    finished.append(req)
                    self._slot_uid[s] = None
                    retired.add(s)
        self._admit(finished)
        return finished

    def step(self) -> list[Request]:
        """Admit waiting requests, run one decode step, retire finished
        ones. Synchronous; returns the requests completed this step."""
        finished: list[Request] = []
        if self._inflight is not None:
            finished.extend(self._process_inflight())
        self._admit(finished)
        fl = self._dispatch(horizon=1)
        if fl is not None:
            self._inflight = fl
            finished.extend(self._process_inflight())
        return finished

    def run(self) -> list[Request]:
        """Drain queue and slots with the pipelined loop."""
        done: list[Request] = []
        for _ in self.stream(_finished=done):
            pass
        return done

    def stream(self, _finished: list | None = None):
        """Generator over (request, token) pairs as the pipelined loop
        observes them. Tokens of one request arrive in order; a request's
        ``done`` flag is set by the time its last token is yielded."""
        prev = self._stream_buf
        self._stream_buf = buf = []
        fin = _finished if _finished is not None else []
        try:
            h = max(1, self.ecfg.horizon)
            self._admit(fin)
            while (self._inflight is not None or self._active_mask().any()
                   or self._sched.pending > 0):
                nxt = self._dispatch(h)
                if self._inflight is not None:
                    fin.extend(self._process_inflight())
                elif nxt is None:
                    self._admit(fin)
                self._inflight = nxt
                while buf:
                    yield buf.pop(0)
        finally:
            if self._stream_buf is buf:
                self._stream_buf = prev
