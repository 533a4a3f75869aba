"""Prompt-lookup speculative decoding — lossless greedy acceleration (port
of ``mxq_tpu/serving/spec.py``).

No draft model: draft tokens are copied from the most recent earlier
occurrence of the sequence's own trailing n-gram (prompt + generated so
far), then verified in ONE multi-token step (:meth:`Engine._verify`,
``llama.decode_slots`` with T = draft + 1): input t of slot b writes its
KV at row positions[b] + t and attends rows <= that, so the logits at input
t are what sequential decode would give IF inputs 0..t were the true
continuation. Greedy outputs equal plain decode's; a draft only changes how
many tokens one verify yields (1 + the longest matching prefix). Rows
written for rejected inputs sit above the accepted frontier: the position
mask hides them and the next verify overwrites them before the frontier
reaches them. On the int8 cache a verify's queries are one K4a call per
layer.

Two loops: :func:`run_spec_pipelined` drafts, verifies and accepts
``rounds`` times per chunk on the device, with no host sync inside the
chunk, and chains chunk k+1 before it reads chunk k (the engine's
pipelined pattern, through ``_HostCopy``); it falls back to the engine's
plain chunks while the acceptance EMA is below the breakeven. :func:`run_spec`
is the synchronous oracle and the near-cache-end fallback.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from mxq_tpu_torch.serving import engine as eng

HIST_WINDOW = 128   # device-resident history (tokens) the drafter can match


def ngram_draft(hist: np.ndarray, ngram: int, draft_len: int) -> np.ndarray:
    """Draft ``draft_len`` tokens by prompt lookup: find the most recent
    earlier occurrence of the trailing ``ngram`` tokens and copy what
    followed it. Falls back to repeating the last token (still verified:
    worst case one token per verify, never a wrong one)."""
    h = np.asarray(hist, np.int32)
    n = min(ngram, len(h) - 1) if len(h) > 1 else 0
    if n > 0:
        key = h[-n:]
        # sliding windows over h[:-1]; the rightmost match wins
        windows = np.lib.stride_tricks.sliding_window_view(h[:-1], n)
        hits = np.nonzero((windows == key).all(axis=1))[0]
        # a hit at i means h[i:i+n] == key; its continuation starts at i+n
        for i in hits[::-1]:
            start = i + n
            if start >= len(h):
                continue
            cont = h[start:start + draft_len]
            if len(cont):
                out = np.full(draft_len, h[-1], np.int32)
                out[: len(cont)] = cont
                return out
    return np.full(draft_len, h[-1], np.int32)


# ---- device-side drafting and acceptance (the pipelined path) ----


def _device_ngram_draft(hist, hist_len, last_tok, ngram: int, d: int):
    """Vectorized prompt lookup over the [B, H] history window (most recent
    token in column H-1, left-padded). Returns drafts [B, d] int32: the
    semantics of :func:`ngram_draft` restricted to the last H tokens."""
    b, h = hist.shape
    n = ngram
    w = h - n                                    # candidate window starts
    dev = hist.device
    key = hist[:, h - n:]                        # [B, n] trailing n-gram
    idx = (torch.arange(w, device=dev)[:, None]
           + torch.arange(n, device=dev)[None, :])
    hist_w = hist[:, idx]                        # [B, W, n]
    starts = torch.arange(w, device=dev)[None, :]
    in_hist = starts >= (h - hist_len[:, None])  # window fully in real tokens
    match = ((hist_w == key[:, None, :]).all(-1) & in_hist
             & (hist_len >= n + 1)[:, None])
    i_best = torch.where(match, starts, -1).amax(dim=1)      # [B]
    cont = (i_best[:, None] + n
            + torch.arange(d, device=dev)[None, :])          # [B, d]
    ok = (i_best >= 0)[:, None] & (cont <= h - 1)
    toks = torch.gather(hist, 1, cont.clamp(0, h - 1))
    return torch.where(ok, toks, last_tok[:, None]).to(torch.int32)


def _accept_count(toks, preds, act):
    """[B] tokens yielded by one verify round: 1 + the number of leading
    draft positions whose draft equals the verified prediction (toks[:, 1:]
    are the drafts, preds[:, :-1] the predictions they must match); 0 for
    slots sitting the round out."""
    ok = (toks[:, 1:] == preds[:, :-1]).to(torch.int32)
    n = 1 + torch.cumprod(ok, dim=1).sum(dim=1)
    return torch.where(act, n, 0).to(torch.int32)


def _hist_append(hist, hist_len, preds, n_acc):
    """Append the first n_acc[b] tokens of preds[b] to each slot's history
    shift register: ext = [hist | preds], new window = ext[n_acc : n_acc+H]
    (the rejected tail, at >= H + n_acc, is never selected)."""
    b, h = hist.shape
    ext = torch.cat([hist, preds], dim=1)
    idx = (n_acc.long()[:, None]
           + torch.arange(h, device=hist.device)[None, :])
    return (torch.gather(ext, 1, idx),
            torch.clamp(hist_len + n_acc, max=h).to(torch.int32))


def _spec_chunk(engine: "eng.Engine", state, active, d: int, rounds: int,
                ngram: int):
    """``rounds`` draft -> verify -> accept rounds for every slot, queued
    on the device with no host sync. ``state`` = (hist [B, H], hist_len,
    pos, last_tok [B]) int32 device tensors, ``active`` [B] bool. Returns
    (state after the chunk, toks [rounds, B, d+1], nacc [rounds, B])."""
    hist, hist_len, pos, last_tok = state
    max_len = engine.ecfg.max_len
    toks_out, nacc_out = [], []
    for _ in range(rounds):
        # slots whose writes could run past the cache sit the round out
        # (the host also bounds the chain)
        act = active & (pos + d + 1 <= max_len - 1)
        drafts = _device_ngram_draft(hist, hist_len, last_tok, ngram, d)
        toks = torch.cat([last_tok[:, None], drafts], dim=1)
        preds = engine._verify(toks, torch.where(act, pos, 0), act)
        # accept draft i while every earlier draft matched its prediction
        n_acc = _accept_count(toks, preds, act)
        last = torch.gather(preds, 1,
                            (n_acc.long() - 1).clamp_min(0)[:, None])[:, 0]
        last_tok = torch.where(act, last, last_tok)
        hist, hist_len = _hist_append(hist, hist_len, preds, n_acc)
        pos = pos + n_acc
        toks_out.append(preds)
        nacc_out.append(n_acc)
    return ((hist, hist_len, pos, last_tok), torch.stack(toks_out),
            torch.stack(nacc_out))


def _build_hist(engine: "eng.Engine", h: int):
    """The history window of every slot, rebuilt on the host from request
    state: ([B, H] int32 left-padded, lengths [B] int32)."""
    b = engine.ecfg.num_slots
    hist = np.zeros((b, h), np.int32)
    hist_len = np.zeros((b,), np.int32)
    for s in range(b):
        uid = engine._slot_uid[s]
        if uid is None:
            continue
        req = engine._reqs[uid]
        full = np.concatenate([np.asarray(req.prompt, np.int32),
                               np.asarray(req.generated, np.int32)])
        tail = full[-h:]
        hist[s, h - len(tail):] = tail
        hist_len[s] = len(tail)
    return hist, hist_len


def _check_can_speculate(engine: "eng.Engine") -> None:
    if not engine.ecfg.greedy:
        raise ValueError("speculative decoding is greedy-only")
    if engine._inflight is not None:
        raise RuntimeError("drain the pipelined decode loop before "
                           "speculative decoding")


def run_spec_pipelined(engine: "eng.Engine", draft_len: int = 4,
                       ngram: int = 3, rounds: int = 4,
                       auto_disable: bool = True,
                       min_accept: "float | None" = None,
                       probe_every: int = 16) -> list:
    """Drain the engine's queue with pipelined speculative greedy decoding:
    drafting and acceptance run on the device (``rounds`` verify rounds per
    chunk) and chunk k+1 is queued before chunk k's tokens are read.
    Acceptance statistics accumulate on the engine (``Engine.stats``:
    ``spec_*``).

    AUTO-DISABLE: where prompt-lookup drafts miss, a verify round costs
    more than it yields, so an EMA of tokens accepted per round is kept;
    below ``min_accept`` (default 0.95 * (draft_len + 1)) the loop runs the
    engine's PLAIN pipelined chunks, re-probing with one spec chunk every
    ``probe_every`` plain chunks. ``auto_disable=False`` keeps speculating
    throughout."""
    _check_can_speculate(engine)
    done: list = []
    b = engine.ecfg.num_slots
    max_len = engine.ecfg.max_len
    dev = engine.device
    d = draft_len
    worst = rounds * (d + 1)
    if min_accept is None:
        min_accept = 0.95 * (d + 1)
    ema_decay = 0.7
    spec_on = True
    plain_since = 0
    engine._spec_stats.setdefault("plain_chunks", 0)
    engine._spec_stats.setdefault("accept_ema", float(d + 1))
    engine._admit(done)
    engine._flush_pending_first(done)

    def process(snap) -> bool:
        """Read one chunk's outputs; True if any slot retired."""
        toks = snap["toks"].numpy()              # [rounds, B, d+1]
        nacc = snap["nacc"].numpy()              # [rounds, B]
        now = time.monotonic()
        retired = False
        st = engine._spec_stats
        st["dispatches"] += 1
        live = nacc[nacc > 0]
        if live.size:
            st["accept_ema"] = (ema_decay * st["accept_ema"]
                                + (1 - ema_decay) * float(live.mean()))
        for r in range(toks.shape[0]):
            for s in range(b):
                uid = snap["uids"][s]
                n = int(nacc[r, s])
                if uid is None or engine._slot_uid[s] != uid or n == 0:
                    continue
                st["rounds"] += 1
                st["accepted"] += n
                req = engine._reqs[uid]
                for i in range(n):
                    tok = int(toks[r, s, i])
                    req.generated.append(tok)
                    if not req.t_first:
                        req.t_first = now
                    engine._last_tok[s] = tok
                    engine._pos[s] += 1
                    if engine._sched.on_token(s, tok):
                        req.done = True
                        req.t_done = now
                        done.append(req)
                        engine._slot_uid[s] = None
                        retired = True
                        break
        return retired

    state = None       # device-chained (hist, hist_len, pos, last_tok)
    state_uids = None  # slot occupancy the chained state was built for
    inflight = None
    pos_bound = None   # worst-case device pos while chunks are in flight
    while engine._active_mask().any() or engine._sched.pending > 0 \
            or inflight is not None or engine._inflight is not None:
        st = engine._spec_stats
        if auto_disable and spec_on and st["accept_ema"] < min_accept:
            spec_on = False
            plain_since = 0
        if not spec_on:
            # PLAIN fallback: drain any spec chunk in flight, then run the
            # engine's own pipelined chunks until the next re-probe
            if inflight is not None:
                process(inflight)
                inflight = None
                state = None
                engine._admit(done)
                engine._flush_pending_first(done)
            if plain_since >= probe_every:
                # re-probe: drain the plain pipeline and neutralize the EMA
                # (one good probe keeps spec on, one bad one disables it)
                if engine._inflight is not None:
                    done.extend(engine._process_inflight())
                # settle deferred prefill first tokens BEFORE the history
                # and last tokens are rebuilt from host truth
                engine._flush_pending_first(done)
                spec_on = True
                st["accept_ema"] = float(min_accept)
                plain_since = 0
                state = None
                continue
            h = max(1, engine.ecfg.horizon)
            nxt = engine._dispatch(h)
            if engine._inflight is not None:
                done.extend(engine._process_inflight())
            elif nxt is None:
                engine._admit(done)
                engine._flush_pending_first(done)
            engine._inflight = nxt
            if nxt is not None:
                st["plain_chunks"] += 1
            plain_since += 1
            continue
        if engine._inflight is not None:
            # back from the plain fallback: settle its last chunk (and the
            # first tokens its admissions produced) before speculating
            done.extend(engine._process_inflight())
            engine._flush_pending_first(done)
            state = None
            continue
        active = engine._active_mask()
        can_chain = (active.any() and state is not None
                     and state_uids == list(engine._slot_uid)
                     and all(pos_bound[s] + worst <= max_len - 1
                             for s in np.where(active)[0]))
        if can_chain:
            state, toks, nacc = _spec_chunk(
                engine, state, eng.to_device(active, dev), d, rounds, ngram)
            snap = dict(toks=eng._HostCopy(toks), nacc=eng._HostCopy(nacc),
                        uids=list(engine._slot_uid))
            for s in np.where(active)[0]:
                pos_bound[s] += worst
            if inflight is not None:
                if process(inflight):
                    # a retirement invalidates the chained state: read the
                    # new chunk too and rebuild from host truth
                    process(snap)
                    snap = None
                    state = None
            inflight = snap
            # admissions change slot occupancy: the state_uids mismatch
            # next iteration forces a drain and rebuild
            engine._admit(done)
            engine._flush_pending_first(done)
            continue
        # resync: drain the chunk in flight, rebuild the device state
        if inflight is not None:
            process(inflight)
            inflight = None
            state = None
            engine._admit(done)
            engine._flush_pending_first(done)
            continue
        if not active.any():
            engine._admit(done)
            engine._flush_pending_first(done)
            if not engine._active_mask().any() \
                    and engine._sched.pending == 0:
                break
            continue
        room = int(min(max_len - 1 - engine._pos[s]
                       for s in np.where(active)[0]))
        if room < worst + 1:
            # near the cache end: the synchronous loop shrinks the draft
            done.extend(run_spec(engine, draft_len=d, ngram=ngram))
            state = None
            continue
        hist, hist_len = _build_hist(engine, HIST_WINDOW)
        state = tuple(eng.to_device(a, dev) for a in (
            hist, hist_len, engine._pos.astype(np.int32),
            engine._last_tok.astype(np.int32)))
        state_uids = list(engine._slot_uid)
        pos_bound = engine._pos.astype(int).copy()
    return done


def run_spec(engine: "eng.Engine", draft_len: int = 4,
             ngram: int = 3) -> list:
    """Drain the engine's queue with prompt-lookup speculative GREEDY
    decoding, one verify per host round trip (drafts drawn on the host).
    Returns the finished requests; their tokens equal ``engine.run()``'s
    greedy tokens. The simple oracle and the near-cache-end fallback of
    :func:`run_spec_pipelined`."""
    _check_can_speculate(engine)
    done: list = []
    engine._admit(done)
    engine._flush_pending_first(done)
    b = engine.ecfg.num_slots
    max_len = engine.ecfg.max_len
    dev = engine.device
    while engine._active_mask().any() or engine._sched.pending > 0:
        active = engine._active_mask()
        if not active.any():
            engine._admit(done)
            engine._flush_pending_first(done)
            continue
        act_idx = np.where(active)[0]
        # one draft length per verify, shrunk so that no slot's writes run
        # past the last cache row
        room = int(min(max_len - 1 - engine._pos[s] for s in act_idx))
        d_eff = max(0, min(draft_len, room - 1))
        drafts = np.zeros((b, d_eff), np.int32)
        for s in act_idx:
            req = engine._reqs[engine._slot_uid[s]]
            hist = np.concatenate([req.prompt[-(max_len - 1):],
                                   np.asarray(req.generated, np.int32)])
            if d_eff:
                drafts[s] = ngram_draft(hist, ngram, d_eff)
        toks = np.concatenate([engine._last_tok[:, None], drafts], axis=1)
        preds = engine._verify(
            eng.to_device(toks, dev),
            eng.to_device(np.where(active, engine._pos, 0).astype(np.int32),
                          dev),
            eng.to_device(active, dev)).cpu().numpy()   # [B, d_eff+1]
        now = time.monotonic()
        engine._spec_stats["dispatches"] += 1
        for s in act_idx:
            uid = engine._slot_uid[s]
            req = engine._reqs[uid]
            consumed = 0
            for i in range(d_eff + 1):
                tok = int(preds[s, i])
                req.generated.append(tok)
                if not req.t_first:
                    req.t_first = now
                consumed += 1
                engine._last_tok[s] = tok
                if engine._sched.on_token(s, tok):
                    req.done = True
                    req.t_done = now
                    done.append(req)
                    engine._slot_uid[s] = None
                    break
                # accept the next draft only if it matches this prediction
                if i < d_eff and int(toks[s, i + 1]) != tok:
                    break
            engine._pos[s] += consumed
            engine._spec_stats["rounds"] += 1
            engine._spec_stats["accepted"] += consumed
        engine._admit(done)
        engine._flush_pending_first(done)
    return done
