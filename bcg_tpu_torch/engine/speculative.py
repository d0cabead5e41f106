"""Prompt-lookup speculative decoding and the plain guided sampler — the
port of ``bcg_tpu/engine/speculative.py``.

Each iteration of the speculative loop (:func:`spec_decode_loop`):

1. samples ONE token through the guided sampler (the fused kernel, with
   the rejected draft token of the previous iteration as ``forbid``);
2. drafts up to K continuation tokens by matching the last N tokens of
   the row's history (prompt + output so far) against that history and
   proposing the continuation of the most recent match, falling back to
   the DFA's forced chain where the n-gram source runs dry
   (:func:`draft_tokens`), truncating at the first grammar- or
   budget-illegal token;
3. verifies the whole [sampled + draft] chunk in ONE forward pass
   (``models/transformer.decode_chunk_spec``: K+1 positions, logits at
   every position, KV written at per-row compacted slots — through the
   block table and the paged kernel's chunk form for a paged cache);
4. accepts the longest draft prefix the model agrees with
   (:func:`accept_draft`): greedy rows while the draft token equals the
   masked argmax (token-identical to the plain loop), sampled rows by
   rejection sampling against the filtered distribution, the rejected
   token carried to the next sample as ``forbid``.

Every per-row quantity (acceptance counts, write positions, the history
buffer) stays on the device; the host reads only the "all rows done"
poll.  :func:`make_masked_logits` / :func:`make_masked_sampler` are the
plain guided sampler: the conformance reference the fused sampler kernel
(:mod:`bcg_tpu_torch.ops.guided_sampler`) is held against, and the
verify pass's filter stage.  The numpy oracles at the bottom are copied
from the JAX package unchanged.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

def spec_decode_slots(max_new: int, k: int) -> int:
    """Decode-tail cache allocation for the speculative loop: per-row
    write positions keep every row's cache compacted (slot count ==
    accepted tokens), so one slot per emittable token plus one K+1-wide
    verify window (and the forced-EOS slot of a budget-exhausted row)
    always fits."""
    return max_new + k + 2


def make_masked_logits(eos_id: int, top_p: float):
    """The filter stage: raw logits -> the masked / temperature-scaled /
    top-p-filtered log-weights the sampler draws from.

    Guaranteed parse: a token is allowed only if the state it leads to can
    still reach acceptance within the remaining budget (``min_budget``
    per (state, token), which also encodes "forbidden" by its sentinel).
    """
    use_top_p = top_p < 1.0

    def masked_logits(logits, states, emitted, tables, accepting, min_budget,
                      dfa_ids, row_temp, row_budget):
        clamped = states.clamp(min=0).long()
        d = dfa_ids.long()
        budget_left = row_budget - emitted              # [B], incl. this token
        allowed = min_budget[d, clamped] <= budget_left[:, None]
        eos_ok = accepting[d, clamped]
        any_tok = allowed.any(dim=-1)
        greedy_row = row_temp <= 0.0
        safe_temp = torch.where(greedy_row, torch.ones_like(row_temp), row_temp)[:, None]
        scaled = logits / safe_temp
        neg = torch.tensor(float("-inf"), device=logits.device)
        lg = torch.where(allowed, scaled, neg)
        # EOS is legal exactly at accepting states.
        lg[:, eos_id] = torch.where(eos_ok, scaled[:, eos_id], neg)
        if use_top_p:
            # Nucleus filter: keep the smallest prefix of the sorted
            # distribution whose mass reaches top_p.
            probs = torch.softmax(lg, dim=-1)
            sorted_probs = torch.sort(probs, dim=-1, descending=True).values
            cum = torch.cumsum(sorted_probs, dim=-1)
            cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True)
            cutoff_idx = cutoff_idx.clamp(max=lg.shape[-1] - 1)
            cutoff = torch.gather(sorted_probs, -1, cutoff_idx)
            lg = torch.where(probs >= cutoff, lg, neg)
        return lg, any_tok, greedy_row

    return masked_logits


def make_masked_sampler(eos_id: int, top_p: float):
    """The full plain sampler (filter + draw).  Sampled rows draw by the
    Gumbel-max trick (``jax.random.categorical``'s method) from
    ``generator``; ``forbid`` masks one token per row after the top-p
    filter.  Returns ``(token [B] int32, next_states [B] int32)``."""
    masked_logits = make_masked_logits(eos_id, top_p)

    def masked_sample(logits, states, generator, emitted, tables, accepting,
                      min_budget, dfa_ids, row_temp, row_budget,
                      forbid: Optional[torch.Tensor] = None):
        lg, any_tok, greedy_row = masked_logits(
            logits, states, emitted, tables, accepting, min_budget, dfa_ids,
            row_temp, row_budget,
        )
        if forbid is not None:
            V = lg.shape[-1]
            hit = (torch.arange(V, device=lg.device)[None, :] == forbid[:, None]) \
                & (forbid >= 0)[:, None]
            lg = torch.where(hit, torch.tensor(float("-inf"), device=lg.device), lg)
        u = torch.rand(lg.shape, generator=generator, device=lg.device)
        gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
        tok = torch.where(greedy_row, torch.argmax(lg, dim=-1),
                          torch.argmax(lg + gumbel, dim=-1))
        # Dead end (no token allowed): force EOS.
        tok = torch.where(any_tok, tok, torch.full_like(tok, eos_id))
        nxt = tables[dfa_ids.long(), states.clamp(min=0).long(), tok].to(torch.int32)
        nxt = torch.where(tok == eos_id, torch.full_like(nxt, -1), nxt)
        return tok.to(torch.int32), nxt

    return masked_sample


# --------------------------------------------------------------- drafter
def draft_tokens(hist, cur0, tok, base_states, done_or_finished,
                 tables, min_budget, chain_tok, chain_len, dfa_ids,
                 emitted, row_budget, *, k: int, n: int, eos_id: int):
    """Propose up to ``k`` draft tokens per row, DFA-truncated.

    ``hist`` ``[B, H]`` int32 token history (prompt + accepted output; -1
    pads), ``cur0`` ``[B]`` written counts, ``tok`` ``[B]`` the
    just-sampled token (not yet in ``hist``), ``base_states`` ``[B]`` DFA
    states after ``tok``.  The n-gram source is the most recent window of
    ``hist`` equal to the last ``n`` tokens (history tail + ``tok``); its
    continuation is proposed position by position, and wherever it is
    absent, exhausted, off-grammar or over budget the state's forced chain
    supplies the token; when neither applies the draft ends.  EOS is never
    drafted.  Returns (draft ``[B, k]``, draft_mask ``[B, k]``, states_v
    ``[B, k]`` — the DFA state after chunk position j — and st_final
    ``[B]``, the state after a fully accepted draft)."""
    B, H = hist.shape
    dev = hist.device
    W = H - n + 1
    eq = torch.ones((B, W), dtype=torch.bool, device=dev)
    if n > 1:
        gidx = cur0[:, None].long() + (torch.arange(n - 1, device=dev)[None, :] - (n - 1))
        gram = torch.gather(hist, 1, gidx.clamp(0, H - 1))
        for j in range(n - 1):
            eq = eq & (hist[:, j:j + W] == gram[:, j:j + 1])
    eq = eq & (hist[:, n - 1:n - 1 + W] == tok[:, None])
    s = torch.arange(W, device=dev)[None, :]
    # Window fully written, with at least one written continuation token;
    # the trivial self-match at the history tail is excluded by the same
    # bound.  The gram prefix needs n-1 written tokens.
    valid_w = (s <= cur0[:, None] - n - 1) & (cur0[:, None] >= n - 1)
    score = torch.where(eq & valid_w, s, torch.full_like(s, -1))
    p = torch.argmax(score, dim=1)                   # most recent match
    found = score.max(dim=1).values >= 0
    cidx = p[:, None] + n + torch.arange(k, device=dev)[None, :]
    cont = torch.gather(hist, 1, cidx.clamp(0, H - 1))
    cont_ok = found[:, None] & (cidx < cur0[:, None])

    d_ids = dfa_ids.long()
    st = base_states.to(torch.int32)
    ng_alive = found
    ok_prev = ~done_or_finished & (st >= 0)
    V = min_budget.shape[-1]
    d_toks, d_ok, states_v = [], [], []
    for j in range(k):
        states_v.append(st)
        stc = st.clamp(min=0).long()
        bl = row_budget - (emitted + 1 + j)
        ng = cont[:, j]
        ng_clip = ng.clamp(0, V - 1).long()
        ng_legal = (ng_alive & cont_ok[:, j] & (ng >= 0) & (ng != eos_id)
                    & (min_budget[d_ids, stc, ng_clip] <= bl))
        ftok = chain_tok[d_ids, stc, 0].long()
        f_legal = ((chain_len[d_ids, stc] > 0) & (ftok != eos_id)
                   & (min_budget[d_ids, stc, ftok] <= bl))
        # Prefer the n-gram source; once it diverges or runs out it stays
        # dead for the rest of this draft.
        d = torch.where(ng_legal, ng_clip, ftok)
        ok = ok_prev & (ng_legal | f_legal)
        ng_alive = ng_alive & ng_legal & ok
        d = torch.where(ok, d, torch.zeros_like(d))
        st = torch.where(ok, tables[d_ids, stc, d].to(torch.int32), st)
        d_toks.append(d)
        d_ok.append(ok)
        ok_prev = ok
    return (torch.stack(d_toks, dim=1), torch.stack(d_ok, dim=1),
            torch.stack(states_v, dim=1), st)


# ------------------------------------------------------------ acceptance
def accept_draft(logits_all, draft, draft_mask, states_v, emitted, generator,
                 tables, accepting, min_budget, dfa_ids, row_temp, row_budget,
                 *, masked_logits, u: Optional[torch.Tensor] = None):
    """Longest-accepted-prefix test over one verify pass.

    ``logits_all`` ``[B, K1, V]`` from ``decode_chunk_spec`` — position
    j's logits score draft index j.  Greedy rows accept while the draft
    token equals the masked argmax; sampled rows accept draft d with
    probability p(d) under the same filtered distribution (``u`` ``[B, K]``
    uniforms, drawn from ``generator`` unless given) and, on rejection,
    report d as the next sample's ``forbid``.  Returns (acc ``[B]``,
    forbid ``[B]``, next_logits ``[B, V]`` at the last accepted chunk
    position)."""
    B, K1, V = logits_all.shape
    K = K1 - 1
    dev = logits_all.device
    ver = logits_all[:, :K].reshape(B * K, V)

    def rep(a):
        return a.repeat_interleave(K, dim=0)

    emitted_v = (emitted[:, None] + 1 + torch.arange(K, device=dev)[None, :]).reshape(-1)
    lg, _any_tok, greedy_row = masked_logits(
        ver, states_v.reshape(-1), emitted_v, tables, accepting, min_budget,
        rep(dfa_ids), rep(row_temp), rep(row_budget),
    )
    greedy_tok = torch.argmax(lg, dim=-1).reshape(B, K)
    p_d = torch.gather(torch.softmax(lg, dim=-1), 1,
                       draft.reshape(-1, 1).long())[:, 0].reshape(B, K)
    if u is None:
        u = torch.rand((B, K), generator=generator, device=dev)
    match = torch.where(greedy_row.reshape(B, K), draft == greedy_tok, u < p_d) & draft_mask
    # Longest accepted prefix: the count of leading matches.
    acc = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
    dlen = draft_mask.sum(dim=1)
    rejected = torch.gather(draft, 1, acc.clamp(0, K - 1)[:, None].long())[:, 0]
    forbid = torch.where(acc < dlen, rejected, torch.full_like(rejected, -1))
    next_logits = torch.gather(logits_all, 1, acc[:, None, None].long().expand(B, 1, V))[:, 0]
    return acc, forbid, next_logits


# ------------------------------------------------------------- spec loop
def spec_decode_loop(params, model_spec, cache, first_logits, valid_mask, prompt_lens,
                     L: int, batch, row_temp, row_budget, hist, generator, *,
                     sampler, eos_id: int, top_p: float, max_new: int, k: int, n: int,
                     done_check: int, all_done=None, census=None):
    """The speculative decode loop (the loop of the JAX package's
    ``build_spec_loop``), eager: greedy rows token-identical to the plain
    loop, sampled rows distribution-preserving.

    ``valid_mask`` ``[B, S]`` attendable cache slots, ``hist``
    ``[B, L + max_new]`` int32 (row i's prompt tokens at
    ``[0, prompt_lens[i])``, -1 elsewhere), ``sampler`` the engine's
    guided sampler (the fused kernel).  The host polls "all rows done"
    every ``done_check`` iterations (``all_done(done) -> bool``, the
    engine's audited poll; default ``bool(done.all())``); iterations after
    every row finished change nothing.  ``census``: the launch census's
    step recorder (``obs/hlo.py``), or None.  Returns ``(out [B, max_new] int32, steps, drafted
    [B], accepted [B])``, all on the device — ``steps`` counts the
    iterations the JAX loop runs.

    Under a mesh every rank of a tp or sp group runs this loop on the same
    rows: the drafts, acceptances and done polls read the sampler's
    tokens and the verify's logits after their collectives, which are the
    same on every rank, so the ranks take the same branches and make the
    same collectives.  A dp rank runs its own rows (``all_done`` polls
    every dp rank's rows where each step writes to every rank's paged
    pool)."""
    from bcg_tpu_torch.models.transformer import decode_chunk_spec

    masked_logits = make_masked_logits(eos_id, top_p)
    B = first_logits.shape[0]
    S = valid_mask.shape[1]
    Hcap = hist.shape[1]
    dev = first_logits.device
    K1 = k + 1
    jr = torch.arange(K1, device=dev)[None, :]
    i32 = torch.int32
    # One spare column each: the target of every dropped per-row write.
    out = torch.full((B, max_new + 1), eos_id, dtype=i32, device=dev)
    hist_buf = torch.cat([hist.to(i32), torch.full((B, 1), -1, dtype=i32, device=dev)], 1)
    vm_buf = torch.cat([valid_mask, torch.zeros((B, 1), dtype=torch.bool, device=dev)], 1)
    vm = vm_buf[:, :S]
    wp = torch.full((B,), L, dtype=torch.int64, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    emitted = torch.zeros((B,), dtype=i32, device=dev)
    states = batch.init_states.to(i32)
    forbid = torch.full((B,), -1, dtype=i32, device=dev)
    drafted = torch.zeros((B,), dtype=torch.int64, device=dev)
    accepted = torch.zeros((B,), dtype=torch.int64, device=dev)
    steps = torch.zeros((), dtype=i32, device=dev)
    logits = first_logits
    eos_t = torch.full((B,), eos_id, dtype=i32, device=dev)
    if all_done is None:
        all_done = lambda d: bool(d.all())  # noqa: E731
    for i in range(max_new):
        if i % done_check == 0 and all_done(done):
            break
        if census is not None:
            census.begin(i)
        steps += (~done.all()).to(i32)
        tok, ns = sampler(logits, states, generator, emitted, batch.tables, batch.accepting,
                          batch.min_budget, batch.dfa_ids, row_temp, row_budget,
                          forbid=forbid)
        tok = torch.where(done, eos_t, tok)
        finished = tok == eos_id
        cur0 = prompt_lens + emitted
        draft, dmask, states_v, st_final = draft_tokens(
            hist_buf[:, :Hcap], cur0, tok, ns, done | finished, batch.tables,
            batch.min_budget, batch.chain_tok, batch.chain_len, batch.dfa_ids,
            emitted, row_budget, k=k, n=n, eos_id=eos_id,
        )
        dlen = dmask.sum(dim=1)
        chunk = torch.cat([tok[:, None].long(), draft], dim=1)
        chunk_valid = (jr == 0) | (jr - 1 < dlen[:, None])
        positions = cur0[:, None] + jr
        logits_all, cache = decode_chunk_spec(params, model_spec, chunk, chunk_valid, wp,
                                              positions, cache, vm)
        acc, forbid2, next_logits = accept_draft(
            logits_all, draft, dmask, states_v, emitted, generator, batch.tables,
            batch.accepting, batch.min_budget, batch.dfa_ids, row_temp, row_budget,
            masked_logits=masked_logits,
        )
        # The accepted chunk prefix -> out / history / attendable slots,
        # at per-row offsets; everything else lands in the spare column.
        accept_f = ((jr == 0) | (jr - 1 < acc[:, None])) & ~done[:, None]
        chunk32 = chunk.to(i32)
        out.scatter_(1, torch.where(accept_f, emitted[:, None] + jr, max_new).long(), chunk32)
        hist_buf.scatter_(1, torch.where(accept_f, cur0[:, None] + jr, Hcap).long(), chunk32)
        vm_buf.scatter_(1, torch.where(accept_f, wp[:, None] + jr, S), accept_f)
        states_full = torch.cat([states_v, st_final[:, None]], dim=1)
        next_state = torch.gather(states_full, 1, acc[:, None].long())[:, 0]
        states = torch.where(done, states, next_state)
        wadv = torch.where(done, torch.zeros_like(acc), 1 + acc)
        emitted = emitted + wadv
        wp = wp + wadv
        drafted += torch.where(done, torch.zeros_like(dlen), dlen)
        accepted += torch.where(done, torch.zeros_like(acc), acc)
        forbid = torch.where(done | finished, torch.full_like(forbid2, -1), forbid2).to(i32)
        logits = torch.where(done[:, None], logits, next_logits)
        done = done | finished
        if census is not None:
            census.end(i)
    if census is not None:
        census.close()
    return out[:, :max_new], steps, drafted, accepted


# ------------------------------------------------------ numpy references
def ngram_draft_np(
    hist: Sequence[int], tok: int, n: int, k: int
) -> List[int]:
    """Host-side oracle for the traced n-gram matcher (no DFA): the
    continuation (up to ``k`` tokens) of the most recent window of
    ``hist`` equal to the last ``n`` tokens of ``hist + [tok]``, with at
    least one written continuation token; [] when no match."""
    hist = list(hist)
    cur0 = len(hist)
    if cur0 < n - 1:
        return []
    gram = hist[cur0 - (n - 1):] + [tok]
    best = -1
    for s in range(0, cur0 - n):  # s + n < cur0
        if hist[s:s + n] == gram:
            best = max(best, s)
    if best < 0:
        return []
    return hist[best + n: best + n + k]


def spec_mirror_np(
    prompt_tokens: Sequence[int], out_tokens: Sequence[int],
    n: int, k: int, eos_id: Optional[int] = None,
) -> Tuple[int, int, int]:
    """Hermetic mirror of the speculative loop's counters for a KNOWN
    output sequence (the FakeEngine, whose "model" is its scripted
    response): runs the reference drafter over prompt + emitted-so-far
    and accepts exactly the draft prefix that agrees with the real
    continuation.  Returns (drafted, accepted, iterations) — the same
    triple the device loop reports, so hermetic serving stats and traces
    are structurally realistic."""
    hist = list(prompt_tokens)
    out = list(out_tokens)
    drafted = accepted = iters = 0
    i = 0
    while i < len(out):
        iters += 1
        tok = out[i]
        draft = [
            t for t in ngram_draft_np(hist, tok, n, k)
            if eos_id is None or t != eos_id
        ]
        good = 0
        for j, d in enumerate(draft):
            if i + 1 + j < len(out) and out[i + 1 + j] == d:
                good += 1
            else:
                break
        drafted += len(draft)
        accepted += good
        hist.extend(out[i: i + 1 + good])
        i += 1 + good
    return drafted, accepted, iters
