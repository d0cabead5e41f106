"""The arithmetic of the cluster sampler (``csrc/guided_sampler.cu``) in
numpy models, against ``sample_rows_plain``, the transcription of the TPU
kernel; and :func:`sampler_plan`, its launch plan.

The models follow the kernel step for step: the 31 thresholds of a 5-level
tree formed per node along its path; six passes that bin the window
[lo, hi) by descending the tree and walk five decisions on suffix sums of
the bins, the mass above ``hi`` carried; the inverse CDF found by the
cluster prefix of CTA sums, the first thread whose chunk ends past the
target, and a walk of that chunk.  Masses are summed in f64 here, so that
no rounding tie decides (the kernel sums in f32 in its own fixed order;
the card tests hold it to the plain version token for token).
"""

import numpy as np
import pytest
import torch

from bcg_tpu_torch.ops import guided_sampler as gs

NEG = np.float32(-1e30)
HALF = np.float32(0.5)


def model_tree(lo, hi):
    """Heap-ordered thresholds (nodes 1..31) as the kernel's make_tree."""
    thr = np.zeros(32, np.float32)
    for node in range(1, 32):
        a, b = np.float32(lo), np.float32(hi)
        for lvl in range(node.bit_length() - 2, -1, -1):
            mid = HALF * (a + b)
            if (node >> lvl) & 1:
                a = mid
            else:
                b = mid
        thr[node] = HALF * (a + b)
    return thr


def recurrence(lo, hi, keeps):
    """The mids of sample_rows_plain's bisection step, in torch f32, for a
    given sequence of decisions."""
    lo = torch.tensor([lo], dtype=torch.float32)
    hi = torch.tensor([hi], dtype=torch.float32)
    mids = []
    for keep in keeps:
        mid = 0.5 * (lo + hi)
        mids.append(np.float32(mid.item()))
        k = torch.tensor([keep])
        lo, hi = torch.where(k, mid, lo), torch.where(k, hi, mid)
    return mids


def model_topp_lo(d, e, t_mass, shortcut=True):
    """The kernel's tree passes over the live elements (d = x - m, e), in
    f64 masses; returns the cutoff lo.  After a pass whose window held at
    most one token, the remaining levels run as the plain recurrence (the
    kernel's exit; ``shortcut=False`` runs all six passes)."""
    lo, hi, mass_hi = np.float32(-30.0), np.float32(1e-6), 0.0
    for p in range(6):
        thr = model_tree(lo, hi)
        win = (d >= lo) & (d < hi)
        dd = d[win]
        node = np.ones(dd.shape, np.int64)
        for _lvl in range(5):
            node = 2 * node + (dd >= thr[node])
        bins = np.bincount(node - 32, weights=e[win].astype(np.float64), minlength=32)
        bins[0] = 0.0
        suf = np.cumsum(bins[::-1])[::-1]
        nlo, nhi, nmass, node = lo, hi, mass_hi, 1
        for lvl in range(5):
            pos = (2 * (node - (1 << lvl)) + 1) << (4 - lvl)
            mass = mass_hi + suf[pos]
            keep = mass >= t_mass
            if keep:
                nlo = thr[node]
            else:
                nhi, nmass = thr[node], mass
            node = 2 * node + int(keep)
        lo, hi, mass_hi = nlo, nhi, nmass
        if shortcut and win.sum() <= 1:
            d1, e1 = (dd[0], float(e[win][0])) if win.sum() else (None, 0.0)
            for _lvl in range((5 - p) * 5):
                mid = HALF * (lo + hi)
                m_mid = mass_hi + (e1 if d1 is not None and mid <= d1 < hi else 0.0)
                if m_mid >= t_mass:
                    lo = mid
                else:
                    hi, mass_hi = mid, m_mid
            break
    return lo


def plain_lo(x, top_p):
    """sample_rows_plain's top-p bisection, step for step, on rows x."""
    m = x.max(dim=-1, keepdim=True).values
    e = torch.where(x > -5e29, torch.exp(x - m), torch.zeros(()))
    t_mass = top_p * e.sum(dim=-1)
    lo = torch.full((x.shape[0],), -30.0)
    hi = torch.full((x.shape[0],), 1e-6)
    for _ in range(30):
        mid = 0.5 * (lo + hi)
        mass = torch.where(x - m >= mid[:, None], e, 0.0).sum(dim=-1)
        keep = mass >= t_mass
        lo, hi = torch.where(keep, mid, lo), torch.where(keep, hi, mid)
    return lo, t_mass


def model_cdf(w, V, Vp, u, plan):
    """The kernel's inverse CDF of the weights ``w`` [V] (f32) at uniform
    ``u`` under ``plan``: CTA sums in rank order, the first CTA whose
    prefix passes the target, its first thread with weight whose chunk
    ends past it (else its last thread with weight), and that chunk's
    first positive weight whose running prefix passes it."""
    T, sl, ch = gs.SAMPLER_THREADS, plan.slice, plan.chunk
    chunks = []
    for r in range(plan.c):
        lo, hi = r * sl, min((r + 1) * sl, V)
        chunks.append([w[max(lo, min(lo + t * ch, hi)):min(lo + (t + 1) * ch, hi)]
                       .astype(np.float64) for t in range(T)])
    sums = [np.array([c.sum() for c in ct]) for ct in chunks]
    total = sum(s.sum() for s in sums)
    target = np.float64(np.float32(u)) * total
    q = 0.0
    for r in range(plan.c):
        if q + sums[r].sum() > target:
            break
        q += sums[r].sum()
    else:
        return Vp - 1
    excl = np.concatenate([[0.0], np.cumsum(sums[r])[:-1]])
    cand = [t for t in range(T) if sums[r][t] > 0 and q + excl[t] + sums[r][t] > target]
    t = cand[0] if cand else max(t for t in range(T) if sums[r][t] > 0)
    run = q + excl[t]
    pick = None
    for j, wj in enumerate(chunks[r][t]):
        if wj > 0:
            run += wj
            pick = r * sl + t * ch + j
            if cand and run > target:
                break
    return pick


def model_rows(logits, minb_rows, meta_i, meta_f, eos, top_p, plan):
    """The whole kernel on numpy rows: [token, any_tok] per row."""
    B, V = logits.shape
    Vp, _ = gs.vocab_rows(V)
    toks, anys = [], []
    for b in range(B):
        budget_left, forbid, greedy, eos_ok = (int(v) for v in meta_i[b])
        temp, u = meta_f[b]
        allowed = minb_rows[b].astype(np.int32) <= budget_left
        vid = np.arange(V)
        gate = np.where(vid == eos, eos_ok > 0, allowed)
        x = np.where(gate, logits[b] / np.float32(temp), NEG).astype(np.float32)
        m = x.max()
        d = x - m
        live = x > NEG * HALF
        e = np.where(live, np.exp(d), np.float32(0)).astype(np.float32)
        if top_p < 1.0:
            z = e.astype(np.float64).sum()
            lo = model_topp_lo(d[live], e[live], np.float64(np.float32(top_p)) * z)
            kept = d >= lo
        else:
            kept = live
        sel = kept & ~((vid == forbid) & (forbid >= 0))
        if greedy > 0:
            xs = np.where(sel, x, NEG)
            hit = np.nonzero(sel & (xs == xs.max()))[0]
            toks.append(int(hit[0]) if hit.size else 1 << 24)
        else:
            toks.append(model_cdf(np.where(sel, e, np.float32(0)), V, Vp, u, plan))
        anys.append(bool(allowed.any()))
    return toks, anys


def _case(rng, B, V, eos=3, allow=0.6):
    minb = rng.integers(1, 6, (B, V)).astype(np.int16)
    minb[rng.random((B, V)) >= allow] = np.iinfo(np.int16).max
    meta_i = np.stack([rng.integers(2, 9, B),
                       np.where(rng.random(B) < 0.4, rng.integers(0, V, B), -1),
                       np.arange(B) % 2, rng.integers(0, 2, B)], axis=1).astype(np.int32)
    meta_f = np.stack([np.full(B, 0.7), rng.random(B)], axis=1).astype(np.float32)
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    return logits, minb, meta_i, meta_f


def _plain(logits, minb, meta_i, meta_f, eos, top_p):
    B = logits.shape[0]
    tok, any_tok = gs.sample_rows_plain(
        torch.from_numpy(logits), torch.from_numpy(minb[None]),
        torch.zeros(B, dtype=torch.int32), torch.arange(B, dtype=torch.int32),
        torch.from_numpy(meta_i), torch.from_numpy(meta_f), eos, top_p)
    return tok.tolist(), any_tok.tolist()


# ------------------------------------------------------------ the tree

STARTS = [(-30.0, 1e-6), (-3.25, -1.5), (-0.001, 1e-6), (-17.0, -16.999998),
          (-1.0000001, -1.0), (-30.0, -29.0), (-1e-7, 1e-6), (-7.5, 0.25)]


@pytest.mark.parametrize("lo,hi", STARTS)
def test_tree_thresholds_equal_the_recurrence_on_every_path(lo, hi):
    thr = model_tree(lo, hi)
    for path in range(32):
        keeps = [bool((path >> (4 - lvl)) & 1) for lvl in range(5)]
        node, want = 1, recurrence(lo, hi, keeps)
        for lvl, keep in enumerate(keeps):
            assert thr[node].tobytes() == want[lvl].tobytes(), (lo, hi, path, lvl)
            node = 2 * node + int(keep)
    # In order, the thresholds never fall: the leaves partition the window.
    order = []

    def walk(n):
        if n < 32:
            walk(2 * n)
            order.append(thr[n])
            walk(2 * n + 1)
    walk(1)
    assert all(a <= b for a, b in zip(order, order[1:]))


@pytest.mark.parametrize("top_p", [0.9, 0.5, 0.99, 0.2])
@pytest.mark.parametrize("seed", range(4))
def test_six_tree_passes_give_the_bisections_cutoff(seed, top_p):
    rng = np.random.default_rng([seed, int(top_p * 100)])
    B, V = 6, 1200
    x = (rng.standard_normal((B, V)) * rng.choice([0.5, 3.0, 8.0], (B, 1)) / 0.7)
    x = x.astype(np.float32)
    x[rng.random((B, V)) < 0.3] = NEG                 # gated tokens
    x[0, :] = NEG                                     # an all-gated row
    x[1, 5:9] = x[1].max()                            # tied maxima
    lo_p, _ = plain_lo(torch.from_numpy(x), top_p)
    for b in range(B):
        live = x[b] > NEG * HALF
        m = x[b].max()
        d = (x[b] - m).astype(np.float32)
        e = np.exp(d[live]).astype(np.float32)
        z = e.astype(np.float64).sum()
        t_mass_b = np.float64(np.float32(top_p)) * z
        lo = model_topp_lo(d[live], e, t_mass_b, shortcut=False)
        assert np.float32(lo).tobytes() == np.float32(lo_p[b].item()).tobytes(), b
        assert np.float32(model_topp_lo(d[live], e, t_mass_b)).tobytes() == \
            np.float32(lo).tobytes(), b


@pytest.mark.parametrize("top_p", [0.9, 0.5, 0.999])
@pytest.mark.parametrize("live", [1, 2, 5, 40])
def test_window_of_one_token_ends_the_passes_with_the_same_cutoff(live, top_p):
    """Rows of few live tokens (a JSON decision's structural states): the
    exit after a window of at most one token gives the six passes' lo and
    the bisection's, bit for bit."""
    rng = np.random.default_rng([live, int(top_p * 1000)])
    x = np.full((8, 600), NEG, np.float32)
    for b in range(8):
        idx = rng.choice(600, live, replace=False)
        x[b, idx] = (rng.standard_normal(live) * rng.choice([0.3, 2.0, 9.0])).astype(np.float32)
    x[1, :2] = x[1].max()                                # tied live tokens
    lo_p, _ = plain_lo(torch.from_numpy(x), top_p)
    for b in range(8):
        live_b = x[b] > NEG * HALF
        d = (x[b] - x[b].max()).astype(np.float32)
        e = np.exp(d[live_b]).astype(np.float32)
        t_mass = np.float64(np.float32(top_p)) * e.astype(np.float64).sum()
        fast = model_topp_lo(d[live_b], e, t_mass)
        full = model_topp_lo(d[live_b], e, t_mass, shortcut=False)
        assert fast.tobytes() == full.tobytes() == np.float32(lo_p[b].item()).tobytes(), b


# ------------------------------------------------------------ the CDF

@pytest.mark.parametrize("V", [300, 151936 // 16, 4099])
@pytest.mark.parametrize("seed", range(3))
def test_chunked_cdf_gives_the_bisections_index(V, seed):
    rng = np.random.default_rng([V, seed])
    B = 8
    logits, minb, meta_i, meta_f = _case(rng, B, V)
    meta_i[:, 2] = 0                                  # every row sampled
    meta_f[0, 1], meta_f[1, 1] = 0.0, np.float32(0.99999994)
    for plan in {gs.sampler_plan(B, V, 1.0), gs.sampler_plan(1, V, 1.0),
                 gs.SamplerPlan(3, -(-V // 24) * 8, gs._chunk(-(-V // 24) * 8), 0, True)}:
        assert model_rows(logits, minb, meta_i, meta_f, 3, 1.0, plan) == \
            _plain(logits, minb, meta_i, meta_f, 3, 1.0)


@pytest.mark.parametrize("V", [300, 1000])
def test_cdf_edges(V):
    """u = 0 picks the first weighted token; u = 0.99999994 the last one
    (never Vp - 1 while any weight is left); a target equal to a prefix
    takes the next token (the prefix must exceed it); no weight at all
    gives Vp - 1, the bisection's upper end over the padded row."""
    Vp, _ = gs.vocab_rows(V)
    B = 5
    logits = np.zeros((B, V), np.float32)
    minb = np.full((B, V), np.iinfo(np.int16).max, np.int16)
    for b, idx in enumerate(([7, 150, V - 1], [0], [V - 1], [], [1, 2])):
        minb[b, idx] = 1                              # equal logits: w = 1 each
    meta_i = np.array([[4, -1, 0, 0]] * B, np.int32)
    for u in (0.0, 0.99999994, 0.5):
        meta_f = np.array([[1.0, u]] * B, np.float32)
        plan = gs.sampler_plan(B, V, 1.0)
        got = model_rows(logits, minb, meta_i, meta_f, 3, 1.0, plan)
        assert got == _plain(logits, minb, meta_i, meta_f, 3, 1.0)
        assert got[0][3] == Vp - 1
        if u == 0.0:
            assert got[0][0] == 7
        if u == 0.99999994:
            assert got[0][0] == V - 1
        if u == 0.5:
            assert got[0][4] == 2


@pytest.mark.parametrize("top_p", [1.0, 0.9])
@pytest.mark.parametrize("seed", range(3))
def test_model_matches_plain_end_to_end(seed, top_p):
    rng = np.random.default_rng([seed, 7])
    B, V = 10, 5000
    logits, minb, meta_i, meta_f = _case(rng, B, V)
    logits[2, 10:14] = logits[2].max() + 1.0          # tied maxima: first index wins
    minb[2, 10:14] = 1
    meta_i[3, 1] = int(np.argmax(np.where(minb[3] <= meta_i[3, 0], logits[3], -np.inf)))
    meta_i[3, 2] = 1                                  # forbid on the greedy argmax
    minb[4] = np.iinfo(np.int16).max                  # an all-gated row
    plan = gs.sampler_plan(B, V, top_p)
    assert model_rows(logits, minb, meta_i, meta_f, 3, top_p, plan) == \
        _plain(logits, minb, meta_i, meta_f, 3, top_p)


# ------------------------------------------------------------ the plan

@pytest.mark.parametrize("top_p", [1.0, 0.9])
@pytest.mark.parametrize("V", [151936, 300, 32000, 4103])
@pytest.mark.parametrize("B", [1, 10, 33, 150])
def test_plan_covers_every_token_once_in_aligned_slices(B, V, top_p):
    plan = gs.sampler_plan(B, V, top_p)
    assert plan.c in gs.CLUSTER_SIZES and plan.slice % 8 == 0
    assert plan.chunk % 8 == 4 and gs.SAMPLER_THREADS * plan.chunk >= plan.slice
    seen = np.zeros(V, np.int64)
    for r in range(plan.c):
        seen[r * plan.slice:min((r + 1) * plan.slice, V)] += 1
    assert (seen == 1).all()
    assert plan.smem_bytes <= gs.SMEM_LIMIT < 227 * 1024
    # x for every thread's chunk, then the staged budgets (or the bins).
    assert plan.smem_bytes >= 4 * gs.SAMPLER_THREADS * plan.chunk + 2 * plan.slice
    # One wave where B clusters fit 132 SMs (the default occupancy holds
    # 132 // c clusters): the largest such c; else the smallest c that fits.
    def fits(c):
        per = -(-V // c)
        ch = gs._chunk(-(-per // 8) * 8)
        smem = 4 * 512 * ch + max(2 * -(-per // 8) * 8, 4 * 32 * 512 if top_p < 1 else 0)
        return (c == 1 or per >= gs.MIN_SLICE) and smem <= gs.SMEM_LIMIT
    wave = [c for c in gs.CLUSTER_SIZES if fits(c) and B * c <= 132]
    if wave:
        assert (plan.c, plan.one_wave) == (max(wave), True)
    else:
        assert plan.c == min(c for c in gs.CLUSTER_SIZES if fits(c))


def test_plan_at_the_bench_decode_step():
    plan = gs.sampler_plan(10, 151936, 1.0)
    assert (plan.c, plan.slice, plan.chunk, plan.one_wave) == (8, 18992, 44, True)
    assert plan.smem_bytes == 4 * 512 * 44 + 2 * 18992
    assert gs.sampler_plan(10, 151936, 0.9).smem_bytes == 4 * 512 * 44 + 4 * 32 * 512
    big = gs.sampler_plan(150, 151936, 0.9)
    assert not big.one_wave and big.c == 8            # the smallest c that fits


def test_plan_follows_the_occupancy_query():
    # Clusters of 16 refused: B = 1 takes 8.
    assert gs.sampler_plan(1, 151936, 1.0, max_clusters=lambda c, s: 0 if c == 16 else 9).c == 8
    # Only 5 clusters of 8 held at once: 10 rows take c = 4.
    held = {16: 2, 8: 5, 4: 20, 2: 0, 1: 0}
    assert gs.sampler_plan(10, 100000, 1.0, max_clusters=lambda c, s: held[c]).c == 4


def test_impossible_plan_raises():
    with pytest.raises(ValueError, match="no cluster plan"):
        gs.sampler_plan(10, 1 << 21, 1.0)
    with pytest.raises(ValueError, match="no cluster plan"):
        gs.sampler_plan(10, 151936, 1.0, max_clusters=lambda c, s: 0)
