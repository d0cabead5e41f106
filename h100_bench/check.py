"""What decides ``correct``: the window's served rows held to the plain
reference, after the window has closed and the program has been freed.

* Every row of the window: its text parses as JSON and obeys its schema
  (:func:`~h100_bench.reference.schema.check_text`), and each served
  token was one the grammar and the row's budget allowed
  (:func:`~h100_bench.reference.schema.walk`).  The count of rows that
  fail either is ``schema_violations``, limit 0.
* A sample of the greedy rows (temperature 0; :func:`sample`): the
  reference's float32 logits at every served position of the prompt
  followed by the served tokens, and at each position the gap by which
  the served token's logit lies below the reference's best token among
  those the grammar allowed there.  A greedy row served by a correct
  program takes the best token of its own logits, so a gap is rounding
  at a near tie and most are 0; one served by a wrong step, cache or
  kernel is not.  The number compared is the widest gap over the sampled
  positions (``max_logit_gap``); the mean is reported beside it (it
  follows how many near ties the seed's greedy rows hold, and overlapped
  between the program and the control across seeds: ``PERF.md``).
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from h100_bench.reference import prompt as ref_prompt
from h100_bench.reference import schema as ref_schema

EOS_COLUMN = 256


@dataclass
class Judged:
    prompt: List[int]
    served: List[int]
    fault: Optional[str]
    positions: List[Tuple[List[int], bool]]
    row: object


def judge_rows(rows, tokenizer: Dict, max_model_len: int) -> List[Judged]:
    """Each row's tokens and its first fault, if any.  A prompt that with
    its budget does not fit ``max_model_len`` is a fault of the traffic
    (the program would serve a cut prompt)."""
    eos = int(tokenizer["eos_id"])
    if eos != EOS_COLUMN:
        raise NotImplementedError("byte tokenizer with EOS at id 256")
    out = []
    for r in rows:
        p = ref_prompt.prompt_tokens(r.system, r.user, tokenizer)
        if r.text is None:
            out.append(Judged(p, [], f"no text ({r.result!r:.120})", [], r))
            continue
        served = ref_prompt.served_tokens(r.text, r.budget, tokenizer)
        fault = ref_schema.check_text(r.text, r.schema)
        if len(p) + r.budget + 1 > max_model_len:
            fault = f"prompt of {len(p)} tokens and budget {r.budget} exceed {max_model_len}"
        walk_fault, positions = ref_schema.walk(r.schema, served, r.budget, eos)
        out.append(Judged(p, served, fault or walk_fault, positions, r))
    return out


def sample(judged: Sequence[Judged], seed: int, min_tokens: int) -> List[Judged]:
    """Greedy rows with no fault: the longest first, rows of one length in
    an order drawn from ``seed``, until ``min_tokens`` served tokens are
    held; then, for each schema that no picked row has (a vote, a
    Byzantine decision), one of its rows drawn from ``seed``.  The longest
    rows carry the most positions at which the grammar leaves a choice;
    each costs the reference a whole prompt, as a short row does."""
    greedy = [j for j in judged if j.row.temperature <= 0.0 and j.fault is None and j.served]
    rng = random.Random(seed)
    keys = [rng.random() for _ in greedy]
    order = [j for _, j in sorted(zip(keys, greedy), key=lambda kj: (-len(kj[1].served), kj[0]))]
    picked, tokens = [], 0
    for j in order:
        if tokens >= min_tokens:
            break
        picked.append(j)
        tokens += len(j.served)
    kinds: Dict[str, List[Judged]] = {}
    for j in order[len(picked):]:
        kinds.setdefault(json.dumps(j.row.schema, sort_keys=True), []).append(j)
    held = {json.dumps(j.row.schema, sort_keys=True) for j in picked}
    for kind in sorted(set(kinds) - held):
        picked.append(kinds[kind][rng.randrange(len(kinds[kind]))])
    return picked


def candidate_mask(positions: Sequence[Tuple[List[int], bool]], device) -> torch.Tensor:
    """``[n, 257]`` bool: the bytes, and EOS in column 256, allowed at
    each served position."""
    mask = torch.zeros((len(positions), EOS_COLUMN + 1), dtype=torch.bool)
    for i, (cands, eos_ok) in enumerate(positions):
        mask[i, cands] = True
        mask[i, EOS_COLUMN] = eos_ok
    return mask.to(device)


def reference_logits(reference, picked: Sequence[Judged]) -> List[torch.Tensor]:
    rows = [(j.prompt + j.served[:-1], len(j.prompt) - 1) for j in picked]
    return [lg[:, : EOS_COLUMN + 1] for lg in reference.logits(rows)]


def margins(ref_logits: Sequence[torch.Tensor], picked: Sequence[Judged]) -> torch.Tensor:
    """At every sampled position where the grammar allows two tokens or
    more, the reference's best allowed logit less its second best: how
    near a tie the position is (``h100_bench.control`` reports it)."""
    out = []
    for lg, j in zip(ref_logits, picked):
        mask = candidate_mask(j.positions, lg.device)
        free = mask.sum(dim=-1) > 1
        top2 = lg.masked_fill(~mask, float("-inf"))[free].topk(2, dim=-1).values
        out.append((top2[:, 0] - top2[:, 1]).float().cpu())
    return torch.cat(out) if out else torch.zeros(0)


def gaps(ref_logits: Sequence[torch.Tensor], picked: Sequence[Judged],
         chooser_logits: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Every sampled position's gap between the reference's best allowed
    logit and the reference's logit of the token taken: the served token,
    or (``chooser_logits``) the best allowed token of another pass's
    logits, lowest id first on a tie, as the program's greedy sampler
    breaks them.  One float32 vector over all sampled rows."""
    out = []
    for i, (lg, j) in enumerate(zip(ref_logits, picked)):
        mask = candidate_mask(j.positions, lg.device)
        masked = lg.masked_fill(~mask, float("-inf"))
        best = masked.max(dim=-1).values
        if chooser_logits is None:
            taken = torch.as_tensor(j.served, device=lg.device)
        else:
            other = chooser_logits[i].masked_fill(~mask, float("-inf"))
            top = other.max(dim=-1, keepdim=True).values
            cols = torch.arange(lg.shape[1], device=lg.device).expand_as(other)
            taken = torch.where(other == top, cols, lg.shape[1]).min(dim=-1).values
        got = lg.gather(1, taken[:, None])[:, 0]
        out.append((best - got).float().cpu())
    return torch.cat(out)
