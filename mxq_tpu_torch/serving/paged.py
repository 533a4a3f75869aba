"""Paged KV pool and paged-attention serving (port of
``mxq_tpu/serving/paged.py``), vLLM-style: sequences take fixed-size pages
on demand from one shared pool, so long and short requests coexist without
a max_len x num_slots reservation, and full prompt pages are shared between
requests through a refcounted prefix cache.

Layout (folded, as in the JAX version): the layer axis is folded into the
page axis,
  k_pages / v_pages : [KVH, L*P, page_size, D] bf16, or for the int8 pool
                      {"codes": [KVH, L*P, 128, D] int8,
                       "scales": [KVH, L*P, 1, 128] bf16}
  page_tables       : [num_slots, pages_per_seq] int32 LOGICAL ids (host)
  lengths           : [num_slots] int32 (host)
Layer ``l``'s copy of logical page ``p`` is physical page ``l*P + p``;
logical page 0 is the null page, never allocated.

Unlike the JAX version, which returns new pool buffers, every function here
writes the pool tensors it is given IN PLACE. Decode of the int8 pool goes
through kernel K11 (``ops.attn_int8.int8_paged_decode_attend_update``),
once per layer per token; ``paged_attend`` on an int8 pool goes through
K9. The bf16 pool, for which the JAX version calls upstream Pallas
``paged_attention`` on the TPU, is gathered and attended with masked
einsum attention, its reference path.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import time
from typing import Optional

import numpy as np
import torch

from mxq_tpu_torch import resolve_device
from mxq_tpu_torch.models import llama
from mxq_tpu_torch.ops import attn_int8
from mxq_tpu_torch.scheme import div_const
from mxq_tpu_torch.serving import kvcache
from mxq_tpu_torch.serving.engine import (NEG, Request, _HostCopy,
                                          sample_token, to_device)

HORIZON = 8     # decode steps per dispatched chunk in PagedEngine.run


@dataclasses.dataclass
class PagedPool:
    """Device KV pool + host-side page accounting (folded layout)."""

    k_pages: object           # [KVH, L*P, ps, D] tensor, or codes/scales
    v_pages: object
    page_size: int
    page_tables: np.ndarray   # [slots, pages_per_seq] int32 LOGICAL (host)
    lengths: np.ndarray       # [slots] int32 (host)
    free_pages: list          # host free list (logical ids)
    layers: int = 0           # L (physical index of (l, p) = l*P + p)
    pages_per_layer: int = 0  # P (logical pool size)

    def __post_init__(self):
        # prefix cache: refcounts, chained hash -> page id, page id -> hash
        self.refs = np.zeros(self.pages_per_layer, np.int32)
        self.prefix_index: dict = {}
        self.page_key: dict = {}

    @classmethod
    def create(cls, cfg: llama.LlamaConfig, num_slots: int, total_pages: int,
               page_size: int = 64, max_len: int = 2048, kv_bits: int = 32,
               device: str | torch.device = "cuda") -> "PagedPool":
        """Zeroed pool tensors on ``device``: bf16 pages, or with
        ``kv_bits`` 8 the int8 pool, whose pages hold 128 rows (the paged
        kernels' page)."""
        dev = resolve_device(device)
        l, kvh, d = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                     cfg.head_dim)
        if kv_bits == 8:
            page_size = attn_int8.PAGE_INT8
        # round UP: a non-multiple max_len must not shrink the capacity
        pages_per_seq = -(-max_len // page_size)
        shape = (kvh, l * total_pages, page_size, d)
        if kv_bits == 8:
            sshape = (kvh, l * total_pages, 1, page_size)

            def quant_pool():
                return {"codes": torch.zeros(shape, dtype=torch.int8,
                                             device=dev),
                        "scales": torch.zeros(sshape, dtype=torch.bfloat16,
                                              device=dev)}
            k_pages, v_pages = quant_pool(), quant_pool()
        else:
            k_pages = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
            v_pages = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
        return cls(
            k_pages=k_pages,
            v_pages=v_pages,
            page_size=page_size,
            page_tables=np.zeros((num_slots, pages_per_seq), np.int32),
            lengths=np.zeros(num_slots, np.int32),
            free_pages=list(range(total_pages - 1, 0, -1)),  # page 0 = null
            layers=l,
            pages_per_layer=total_pages,
        )

    # -- host-side page accounting -------------------------------------
    # Full prompt pages are content-addressed by a CHAINED hash (equal ids
    # imply equal full prefixes) and shared read-only between sequences by
    # refcount. A released page keeps its index entry while it sits in
    # the free list; reallocating it for new content invalidates it.

    def alloc_page(self) -> int:
        if not self.free_pages:
            raise RuntimeError("KV pool exhausted")
        # prefer pages NOT holding cached prefixes; cannibalize the
        # oldest-freed cached page only when nothing else is left
        for i in range(len(self.free_pages) - 1, -1, -1):
            if self.free_pages[i] not in self.page_key:
                p = self.free_pages.pop(i)
                break
        else:
            p = self.free_pages.pop(0)
        h = self.page_key.pop(p, None)
        if h is not None and self.prefix_index.get(h) == p:
            del self.prefix_index[h]    # page reused for new content
        self.refs[p] = 1
        return p

    def acquire_cached(self, h) -> Optional[int]:
        """Attach a cached prefix page (refcount++), or None on miss."""
        p = self.prefix_index.get(h)
        if p is None:
            return None
        if self.refs[p] == 0:
            try:
                self.free_pages.remove(p)
            except ValueError:          # already reallocated
                return None
        self.refs[p] += 1
        return p

    def register_prefix(self, h, page_id: int) -> None:
        if h not in self.prefix_index:
            self.prefix_index[h] = int(page_id)
            self.page_key[int(page_id)] = h

    def ensure_capacity(self, slot: int, new_len: int) -> None:
        need = -(-new_len // self.page_size)
        have = int(np.sum(self.page_tables[slot] != 0))
        while have < need:
            self.page_tables[slot, have] = self.alloc_page()
            have += 1

    def release(self, slot: int) -> None:
        for j, pg in enumerate(self.page_tables[slot]):
            if pg != 0:
                self.refs[pg] -= 1
                if self.refs[pg] <= 0:
                    self.refs[pg] = 0
                    # cached prefix pages stay indexed while free: a later
                    # identical prompt re-acquires them from here
                    self.free_pages.append(int(pg))
            self.page_tables[slot, j] = 0
        self.lengths[slot] = 0


def write_tokens(k_pages, v_pages, k_new, v_new, page_ids, offsets,
                 layer_idx=None, pages_per_layer=None):
    """Write one token per slot into the pool, IN PLACE.

    k_new/v_new: [B, KVH, D]; page_ids/offsets: [B] (LOGICAL page ids).
    With ``layer_idx`` (+ ``pages_per_layer``) the rows go to the folded
    pool's physical pages ``layer_idx*P + page_ids``; else ``page_ids``
    index the pool as given. An int8 pool gets per-(slot, head) symmetric
    codes and bf16 scales (``kvcache.quantize_kv``, group = head_dim).
    Returns (k_pages, v_pages), the same objects."""
    lp = page_ids if layer_idx is None else \
        layer_idx * pages_per_layer + page_ids
    lp, off = lp.long(), offsets.long()
    for pages, val in ((k_pages, k_new), (v_pages, v_new)):
        if isinstance(pages, dict):
            codes, scales = kvcache.quantize_kv(val.float(), val.shape[-1])
            pages["codes"][:, lp, off] = codes.transpose(0, 1)
            pages["scales"][:, :, 0][:, lp, off] = \
                scales[..., 0].to(torch.bfloat16).T
        else:
            pages[:, lp, off] = val.transpose(0, 1).to(pages.dtype)
    return k_pages, v_pages


def _pool_codes(pages):
    """The tensor carrying page geometry ([KVH, L*P, ps, D]): the codes of
    an int8 (dict) pool, the pages themselves otherwise."""
    return pages["codes"] if isinstance(pages, dict) else pages


def _lp(dest_pages, layers: int, pages_per_layer: int):
    """Physical page ids [L, NP] (int64) of logical ``dest_pages`` [NP] in
    every layer (folded layout: (l, p) -> l*P + p)."""
    return (torch.arange(layers, device=dest_pages.device)[:, None]
            * pages_per_layer + dest_pages.long()[None, :])


def _scatter_quant(pages, buf, t, ps, dest_pages, pages_per_layer,
                   offset=0):
    """Quantize a prefill chunk (dense [L, 1, T+, KVH, D] cache, rows
    [offset, offset+t)) and write codes + scales into logical
    ``dest_pages`` of every layer, in place."""
    l, kvh, d = buf.shape[0], buf.shape[3], buf.shape[4]
    x = buf[:, 0, offset:offset + t]
    codes, scales = kvcache.quantize_kv(x.float(), d)
    # -> [KVH, L, NP, ps, D] to match the folded pool's [KVH, LP, ...]
    cc = codes.reshape(l, t // ps, ps, kvh, d).permute(3, 0, 1, 2, 4)
    ss = scales[..., 0].reshape(l, t // ps, ps, kvh).permute(3, 0, 1, 2)
    lp = _lp(dest_pages, l, pages_per_layer)          # [L, NP]
    pages["codes"][:, lp] = cc
    pages["scales"][:, :, 0][:, lp] = ss.to(torch.bfloat16)


def _gather_dense(pages, page_table, l, kvh, d, ps, pages_per_layer):
    """Gather a slot's pages to a dense [L, 1, cap, KVH, D] cache
    (dequantized to bf16 from an int8 pool)."""
    cap = page_table.shape[0] * ps
    lp = _lp(page_table, l, pages_per_layer)          # [L, NP]
    if isinstance(pages, dict):
        g = pages["codes"][:, lp]                     # [KVH, L, NP, ps, D]
        s = pages["scales"][:, :, 0][:, lp]           # [KVH, L, NP, ps]
        dense = (g.float() * s.float()[..., None]).to(torch.bfloat16)
    else:
        dense = pages[:, lp]
    return dense.permute(1, 2, 3, 0, 4).reshape(l, 1, cap, kvh, d)


def paged_attend(q, k_pages_l, v_pages_l, lengths, page_indices):
    """q [B, NH, D]; k/v_pages_l: one layer's view [KVH, P, ps, D] or the
    whole folded pool with ``page_indices`` [B, PPS] already physical
    (l*P + p). Rows < lengths[b] are attended. An int8 (dict) pool goes
    through K9; a bf16 pool through :func:`_paged_attend_reference`.
    Returns [B, NH, D] in q's type."""
    if isinstance(k_pages_l, dict):
        return attn_int8.int8_paged_decode_attention(
            q, k_pages_l["codes"], k_pages_l["scales"],
            v_pages_l["codes"], v_pages_l["scales"],
            lengths, page_indices).to(q.dtype)
    return _paged_attend_reference(q, k_pages_l, v_pages_l, lengths,
                                   page_indices)


def _paged_attend_reference(q, k_pages_l, v_pages_l, lengths, page_indices):
    """Gather each sequence's pages and attend them with a length mask."""
    b, nh, d = q.shape
    kvh, _, ps, _ = k_pages_l.shape
    pps = page_indices.shape[1]
    idx = page_indices.long()
    # gather each sequence's pages -> [B, KVH, pps*ps, D]
    k = k_pages_l[:, idx].transpose(0, 1).reshape(b, kvh, pps * ps, d)
    v = v_pages_l[:, idx].transpose(0, 1).reshape(b, kvh, pps * ps, d)
    rep = nh // kvh
    k = torch.repeat_interleave(k, rep, dim=1).float()
    v = torch.repeat_interleave(v, rep, dim=1).float()
    scores = div_const(torch.einsum("bhd,bhsd->bhs", q.float(), k),
                       math.sqrt(d))
    pos = torch.arange(pps * ps, device=q.device)[None, None, :]
    scores = torch.where(pos < lengths[:, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhs,bhsd->bhd", probs, v).to(q.dtype)


def paged_decode_step(params, k_pages, v_pages, tokens, positions,
                      page_tables, cfg: llama.LlamaConfig):
    """One decode token for every slot against the paged pool.

    tokens [B, 1]; positions [B] int32 (each slot's write row, which it
    attends up to and including); page_tables [B, PPS] int32 logical ids.
    The pool is written in place. Returns (next_token_logits [B, V] f32,
    k_pages, v_pages)."""
    nl = cfg.num_hidden_layers
    _, lp_total, ps, _ = _pool_codes(k_pages).shape
    ppl = lp_total // nl
    # physical page tables of every layer, [L, B, PPS] int32
    lp_tables = (torch.arange(nl, dtype=torch.int32,
                              device=page_tables.device)[:, None, None]
                 * ppl + page_tables)
    if isinstance(k_pages, dict):
        def attend(idx, q, k, v):
            kc, ks = kvcache.quantize_kv(k[:, 0].float(), cfg.head_dim)
            vc, vs = kvcache.quantize_kv(v[:, 0].float(), cfg.head_dim)
            ctx, *_ = attn_int8.int8_paged_decode_attend_update(
                q[:, 0], k_pages["codes"], k_pages["scales"],
                v_pages["codes"], v_pages["scales"], kc, ks[..., 0], vc,
                vs[..., 0], positions, lp_tables[idx])
            return ctx
    else:
        # the write page and row of each slot (K11 finds them itself). A
        # slot sitting out a chunk near its capacity may index past its
        # table: clamp as the JAX gather does (its token is dropped)
        rows = torch.arange(positions.shape[0], device=positions.device)
        pps = page_tables.shape[1]
        page_ids = page_tables[rows,
                               (positions // ps).clamp(max=pps - 1).long()]

        def attend(idx, q, k, v):
            write_tokens(k_pages, v_pages, k[:, 0], v[:, 0], page_ids,
                         positions % ps, layer_idx=idx, pages_per_layer=ppl)
            return paged_attend(q[:, 0], k_pages, v_pages, positions + 1,
                                lp_tables[idx])
    logits = llama.decode_step(params, tokens, cfg, positions, attend)
    return logits[:, 0], k_pages, v_pages


def paged_decode_chunk(params, k_pages, v_pages, chained, host_toks,
                       use_chain, positions, active, page_tables,
                       generator: torch.Generator, cfg: llama.LlamaConfig,
                       horizon: int, sample: tuple = (True, 1.0, 0, 1.0)):
    """``horizon`` decode steps against the paged pool: each substep's
    write rows follow on the device from the advancing positions and the
    device page table (:func:`paged_decode_step`), so the host neither
    precomputes them nor waits between steps. Input tokens chain from the
    previous chunk's output on the device (``chained``) except where
    ``use_chain`` is False (freshly admitted slots). The caller must have
    allocated pages covering positions + horizon. ``sample`` = (greedy,
    temperature, top_k, top_p). Returns (tokens [horizon, B] int32,
    k_pages, v_pages)."""
    toks = torch.where(use_chain, chained, host_toks)[:, None]
    out = []
    for i in range(horizon):
        logits, _, _ = paged_decode_step(params, k_pages, v_pages, toks,
                                         positions + i, page_tables, cfg)
        nxt = sample_token(logits, generator, *sample)
        nxt = torch.where(active, nxt, 0).to(torch.int32)
        out.append(nxt)
        toks = nxt[:, None]
    return torch.stack(out), k_pages, v_pages


def _prefill_mask(t, s, offset, length, device):
    """[1, 1, T, S] additive mask: query i (at row offset+i) sees keys
    k <= offset+i that lie below offset+length."""
    qpos = offset + torch.arange(t, device=device)[:, None]
    kpos = torch.arange(s, device=device)[None, :]
    return torch.where((kpos <= qpos) & (kpos < offset + length), 0.0,
                       NEG)[None, None]


def paged_prefill(params, k_pages, v_pages, ids, length: int, slot_pages,
                  generator: torch.Generator, cfg: llama.LlamaConfig,
                  sample: tuple = (True, 1.0, 0, 1.0)):
    """Prefill one prompt ids [1, T_bucket] (``length`` real tokens)
    through a dense bf16 cache and write its KV into the slot's pages
    ``slot_pages`` [T_bucket // page_size] in place. Returns (the first
    generated token [] int32 on the device, k_pages, v_pages)."""
    dev = ids.device
    t = ids.shape[1]
    pc = _pool_codes(k_pages)
    ps = pc.shape[2]
    l = cfg.num_hidden_layers
    ppl = pc.shape[1] // l
    caches = llama.init_cache(
        cfg, 1, t, dtype=(torch.bfloat16 if isinstance(k_pages, dict)
                          else k_pages.dtype), device=dev)
    logits, caches = llama.forward(params, ids, cfg, caches=caches,
                                   cache_pos=0,
                                   mask=_prefill_mask(t, t, 0, length, dev),
                                   device=dev)
    for pages, buf in ((k_pages, caches["k"]), (v_pages, caches["v"])):
        if isinstance(pages, dict):
            _scatter_quant(pages, buf, t, ps, slot_pages, ppl)
        else:
            chunk = buf[:, 0].reshape(l, t // ps, ps, buf.shape[3],
                                      buf.shape[4]).permute(3, 0, 1, 2, 4)
            pages[:, _lp(slot_pages, l, ppl)] = chunk.to(pages.dtype)
    first = sample_token(logits[0:1, length - 1], generator, *sample)[0]
    return first, k_pages, v_pages


def paged_prefill_chunk(params, k_pages, v_pages, ids, length: int,
                        offset: int, slot_page_table, chunk_pages,
                        generator: torch.Generator, cfg: llama.LlamaConfig,
                        sample: tuple = (True, 1.0, 0, 1.0)):
    """Continuation prefill chunk ids [1, T_bucket] at cache row
    ``offset``: the slot's pages (``slot_page_table`` [PPS]) are gathered
    to a dense prefix cache, so the chunk's queries attend rows
    [0, offset) plus their own causal prefix; the fresh chunk KV is
    written into ``chunk_pages`` in place. Returns (first token, k_pages,
    v_pages)."""
    dev = ids.device
    t = ids.shape[1]
    kvh, lp_total, ps, d = _pool_codes(k_pages).shape
    l = cfg.num_hidden_layers
    ppl = lp_total // l
    cap = slot_page_table.shape[0] * ps
    caches = {"k": _gather_dense(k_pages, slot_page_table, l, kvh, d, ps,
                                 ppl),
              "v": _gather_dense(v_pages, slot_page_table, l, kvh, d, ps,
                                 ppl)}
    logits, caches = llama.forward(
        params, ids, cfg, caches=caches, cache_pos=offset,
        mask=_prefill_mask(t, cap, offset, length, dev), device=dev)
    for pages, buf in ((k_pages, caches["k"]), (v_pages, caches["v"])):
        if isinstance(pages, dict):
            _scatter_quant(pages, buf, t, ps, chunk_pages, ppl,
                           offset=offset)
        else:
            fresh = buf[:, 0, offset:offset + t]
            chunk = fresh.reshape(l, t // ps, ps, kvh, d).permute(
                3, 0, 1, 2, 4)
            pages[:, _lp(chunk_pages, l, ppl)] = chunk.to(pages.dtype)
    first = sample_token(logits[0:1, length - 1], generator, *sample)[0]
    return first, k_pages, v_pages


class PagedEngine:
    """Continuous batching over the paged pool (the host protocol of
    ``engine.Engine``, vLLM-style memory management), with the same
    pipelined multi-step dispatch: chunk k+1 launches before chunk k's
    tokens are read, tokens chain on the device, and pages for the whole
    chunk are allocated at dispatch. ``run`` dispatches chunks of
    :data:`HORIZON` steps, ``step`` chunks of one. A sequence within a chunk
    of its per-slot page capacity is retired at dispatch time (up to
    HORIZON-1 tokens earlier than the strict cap). Sampling draws from one
    ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, params, cfg: llama.LlamaConfig, num_slots: int = 8,
                 total_pages: int = 512, page_size: int = 64,
                 max_len: int = 2048, prefill_bucket: int = 128,
                 greedy: bool = True,
                 temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 1.0, seed: int = 0, kv_bits: int = 32,
                 device: str | torch.device = "cuda"):
        self.device = dev = resolve_device(device)
        llama.check_params_device(params, dev)
        self.params = params
        self.cfg = cfg
        self.sample = (greedy, temperature, top_k, top_p)
        self._gen = torch.Generator(device=dev).manual_seed(seed)
        self.pool = PagedPool.create(cfg, num_slots, total_pages, page_size,
                                     max_len, kv_bits=kv_bits, device=dev)
        self.num_slots = num_slots
        self.prefill_bucket = prefill_bucket
        self.slot_req = [None] * num_slots
        self.queue: list = []
        self._all_reqs: list = []       # every request ever submitted
        self._uid = 0
        self._count = np.zeros(num_slots, np.int64)    # tokens incl. prefill
        self._last_tok = np.zeros(num_slots, np.int32)
        self._admit_gen = np.zeros(num_slots, np.int64)
        self._inflight = None
        self.prefix_hits = 0            # prompt pages taken from the cache

    def submit(self, prompt, max_new_tokens=64, eos_token_id=None):
        req = Request(self._uid, np.asarray(prompt, np.int32),
                      max_new_tokens, eos_token_id, t_submit=time.monotonic())
        self._uid += 1
        self.queue.append(req)
        self._all_reqs.append(req)
        return req

    def _prefill_slot(self, slot, req, tail, t, cap, ps):
        """Prefix-cache match + chunked prefill for one admitted request.
        Returns (first token on the device, matched_pages, page_hashes)."""
        hashes = []
        h = b"prefix-root"
        for i in range((t - 1) // ps):
            h = hashlib.sha1(
                h + np.asarray(tail[i * ps:(i + 1) * ps],
                               np.int32).tobytes()).digest()
            hashes.append(h)
        matched = 0
        for i, hh in enumerate(hashes):
            p = self.pool.acquire_cached(hh)
            if p is None:
                break
            self.pool.page_tables[slot, i] = p
            matched += 1
        self.prefix_hits += matched
        off0 = matched * ps
        # fixed-size chunks (a multiple of the page size): prompts beyond
        # one chunk continue via paged_prefill_chunk
        chunk = -(-min(max(self.prefill_bucket, ps), cap) // ps) * ps
        first = None
        pool = self.pool
        for off in range(off0, t, chunk):
            sub = tail[off:off + chunk]
            ts = len(sub)
            bucket = min(chunk, -(-ts // ps) * ps)
            pool.ensure_capacity(slot, off + bucket)
            pages = pool.page_tables[slot]
            ids = np.zeros((1, bucket), np.int32)
            ids[0, :ts] = sub
            ids = to_device(ids, self.device)
            if off == 0:
                first, _, _ = paged_prefill(
                    self.params, pool.k_pages, pool.v_pages, ids, ts,
                    to_device(pages[:bucket // ps], self.device), self._gen,
                    self.cfg, sample=self.sample)
            else:
                first, _, _ = paged_prefill_chunk(
                    self.params, pool.k_pages, pool.v_pages, ids, ts, off,
                    to_device(pages, self.device),
                    to_device(pages[off // ps: off // ps + bucket // ps],
                              self.device),
                    self._gen, self.cfg, sample=self.sample)
        return first, matched, hashes

    def _admit(self, finished: list) -> None:
        ps = self.pool.page_size
        for slot in range(self.num_slots):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            # clamp to the slot's capacity keeping the LAST tokens, with one
            # position of headroom for the first decode write
            cap = self.pool.page_tables.shape[1] * ps
            tail = req.prompt[-(cap - 1):]
            t = len(tail)
            try:
                first, matched, hashes = self._prefill_slot(slot, req, tail,
                                                            t, cap, ps)
            except Exception:
                # roll back this slot's acquired/allocated pages so a caught
                # pool exhaustion cannot leave foreign pages in the table (a
                # later admit would adopt and overwrite them, corrupting
                # prefixes other live sequences still read)
                self.pool.release(slot)
                self.queue.insert(0, req)
                raise
            first = int(first)          # waits for the prefill
            # publish this prompt's own full pages for future prefix hits
            for i in range(matched, len(hashes)):
                self.pool.register_prefix(
                    hashes[i], int(self.pool.page_tables[slot, i]))
            req.t_first = time.monotonic()
            req.generated = [first]
            self.slot_req[slot] = req
            self.pool.lengths[slot] = t
            self._count[slot] = 1
            self._last_tok[slot] = first
            self._admit_gen[slot] += 1
            if req.max_new_tokens <= 1:
                req.done = True
                req.t_done = time.monotonic()
                finished.append(req)
                self.pool.release(slot)
                self.slot_req[slot] = None

    def _dispatch(self, horizon: int):
        ps = self.pool.page_size
        cap = self.pool.page_tables.shape[1] * ps
        # sequences without room for a whole chunk sit this dispatch out;
        # _process_inflight retires them once their in-flight tokens are
        # consumed
        active = np.array([
            r is not None and self.pool.lengths[s] + horizon <= cap
            for s, r in enumerate(self.slot_req)])
        if not active.any():
            return None
        for s in np.where(active)[0]:
            self.pool.ensure_capacity(s, int(self.pool.lengths[s]) + horizon)
        b = self.num_slots
        if self._inflight is not None:
            fl = self._inflight
            chained = fl["toks"][-1]
            use_chain = (fl["active"] & active
                         & (fl["gen"] == self._admit_gen))
        else:
            chained = torch.zeros((b,), dtype=torch.int32, device=self.device)
            use_chain = np.zeros(b, bool)
        dev = self.device
        toks, _, _ = paged_decode_chunk(
            self.params, self.pool.k_pages, self.pool.v_pages, chained,
            to_device(self._last_tok, dev), to_device(use_chain, dev),
            to_device(self.pool.lengths.astype(np.int32), dev),
            to_device(active, dev), to_device(self.pool.page_tables, dev),
            self._gen, self.cfg, horizon, sample=self.sample)
        snap = dict(toks=toks, host=_HostCopy(toks), active=active,
                    gen=self._admit_gen.copy(), reqs=list(self.slot_req),
                    horizon=horizon)
        for s in np.where(active)[0]:
            self.pool.lengths[s] += horizon
        return snap

    def _process_inflight(self) -> list:
        fl = self._inflight
        self._inflight = None
        toks = fl["host"].numpy()
        finished = []
        retired = set()
        for i in range(fl["horizon"]):
            for s in np.where(fl["active"])[0]:
                r = fl["reqs"][s]
                if s in retired or r is None or self.slot_req[s] is not r:
                    continue
                tok = int(toks[i, s])
                r.generated.append(tok)
                self._count[s] += 1
                self._last_tok[s] = tok
                hit_eos = (r.eos_token_id is not None
                           and tok == r.eos_token_id)
                if self._count[s] >= r.max_new_tokens or hit_eos:
                    r.done = True
                    r.t_done = time.monotonic()
                    finished.append(r)
                    self.pool.release(s)
                    self.slot_req[s] = None
                    retired.add(s)
        self._retire_at_cap(finished, fl["horizon"])
        self._admit(finished)
        return finished

    def _retire_at_cap(self, finished: list, horizon: int) -> None:
        """Retire sequences that can no longer fit a whole chunk."""
        cap = self.pool.page_tables.shape[1] * self.pool.page_size
        for s, r in enumerate(self.slot_req):
            if r is not None and self.pool.lengths[s] + horizon > cap:
                r.done = True
                r.t_done = time.monotonic()
                finished.append(r)
                self.pool.release(s)
                self.slot_req[s] = None

    def step(self):
        finished = []
        if self._inflight is not None:
            finished.extend(self._process_inflight())
        self._admit(finished)
        fl = self._dispatch(1)
        if fl is not None:
            self._inflight = fl
            finished.extend(self._process_inflight())
        else:
            self._retire_at_cap(finished, 1)
        return finished

    def stats(self) -> dict:
        """TTFT / end-to-end percentiles and throughput over all requests
        this engine has seen (the paged mirror of Engine.stats()), and the
        prompt pages the prefix cache supplied instead of a prefill."""
        reqs = self._all_reqs
        fin = [r for r in reqs if r.done and r.t_first and r.t_done]
        out = {"requests_submitted": len(reqs),
               "requests_finished": len(fin),
               "tokens_generated": sum(len(r.generated) for r in reqs),
               "prefix_pages_hit": self.prefix_hits}
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
        return out

    def run(self):
        done = []
        h = HORIZON
        self._admit(done)
        while (self._inflight is not None
               or any(r is not None for r in self.slot_req) or self.queue):
            nxt = self._dispatch(h)
            if self._inflight is not None:
                done.extend(self._process_inflight())
            elif nxt is None:
                self._retire_at_cap(done, h)
                self._admit(done)
            self._inflight = nxt
        return done
