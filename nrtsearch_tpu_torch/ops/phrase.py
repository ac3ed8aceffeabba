"""Phrase verification on the device: vectorized position matching
(counterpart: nrtsearch_tpu/ops/phrase.py).

The reference runs this as one jitted XLA program over all candidates; it
reaches no Pallas kernel. The port runs the same steps as torch ops on the
segment's device, eagerly, in the reference's order:

  1. **Entry lookup**: for every (candidate doc, phrase term) pair, a
     vectorized binary search over the term's doc-sorted postings run
     (``steps`` rounds of gathers) finds the postings entry.
  2. **Window gather**: each entry's positions (the CSR over postings
     entries, uploaded once per field) go into a fixed [C, L] window per
     term, L the power of two at or above the largest per-entry position
     count among the query's terms (at least 8), so no position is cut.
  3. **Alignment check**: for every position p of the first term,
     membership of p + offset_t in term t's sorted window, by a binary
     search over the L lanes. Exact phrases need every term aligned;
     sloppy ones sum each term's nearest-position displacement (f32) and
     compare it with the slop: the greedy approximation of Lucene's sloppy
     frequency the host loop (``query.eval._phrase_freq``) also computes.
  4. **Scoring**: phrase freq -> BM25 tf norm times the summed idf,
     scattered into dense [D] scores and match.

Phrase-prefix queries add the expansions of the last term as a second
window group whose membership is OR-reduced (min displacement when sloppy).

Padding is the reference's: C and L are powers of two, pads are INT_MAX,
and ``run_phrase`` returns None where the reference's does, so the same
queries take the host loop. Two things differ in form only:

- the scatter writes the real candidates (distinct docs) and sends every
  pad to a dump slot past the segment: the reference scatters pads to doc
  0 with add / max, which a plain CUDA write with repeated indices would
  turn into a race with candidate 0's value;
- ``tf + k1 * norm`` is computed in f64 and rounded once, the fused
  multiply-add XLA's CPU build emits (as ``ops.bm25``).
"""

from __future__ import annotations

import numpy as np
import torch

from nrtsearch_tpu_torch.device import scalar_f32

INT_MAX = 2**31 - 1


def _pow2(n: int, minimum: int = 1) -> int:
    b = minimum
    while b < n:
        b <<= 1
    return b


def _search_entries(post_docs: torch.Tensor, off: int, ln: int, cand: torch.Tensor,
                    steps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Vectorized binary search of ``cand`` [C] in one postings run.
    Returns (entry position within the run [C] int64, found [C])."""
    last = max(ln - 1, 0)
    lo = torch.zeros(cand.shape, dtype=torch.int64, device=cand.device)
    hi = torch.full(cand.shape, max(ln, 0), dtype=torch.int64, device=cand.device)
    for _ in range(steps):
        mid = (lo + hi) // 2
        v = post_docs[off + torch.clamp(mid, max=last)]
        go_hi = v < cand
        lo = torch.where(go_hi, mid + 1, lo)
        hi = torch.where(go_hi, hi, mid)
    pos = torch.clamp(lo, max=last)
    found = (lo < ln) & (post_docs[off + pos] == cand)
    return pos, found


def _gather_window(pos_flat: torch.Tensor, pos_offs: torch.Tensor, entry: torch.Tensor,
                   found: torch.Tensor, L: int) -> torch.Tensor:
    """[C] entries -> sorted position windows [C, L], INT_MAX past each
    entry's positions (and everywhere for a candidate without the term)."""
    start = pos_offs[entry]
    w_len = torch.where(found, pos_offs[entry + 1] - start, torch.zeros_like(start))
    iota = torch.arange(L, dtype=torch.int64, device=entry.device)
    idx = torch.clamp(start.long()[:, None] + iota[None, :], 0, pos_flat.shape[0] - 1)
    valid = iota[None, :] < w_len[:, None]
    return torch.where(valid, pos_flat[idx], torch.full((), INT_MAX, dtype=torch.int32,
                                                        device=entry.device))


def _window_lookup(w: torch.Tensor, want: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """For sorted windows ``w`` [C, L] (INT_MAX padded) and targets ``want``
    [C, L]: binary search -> (value at the insertion point, value before
    it), INT_MAX where there is none."""
    L = w.shape[1]
    lo = torch.zeros(want.shape, dtype=torch.int64, device=w.device)
    hi = torch.full(want.shape, L, dtype=torch.int64, device=w.device)
    for _ in range(max(int(L).bit_length(), 1)):
        # guard converged lanes: an unguarded extra round at lo == hi == L
        # would read past the window and run lo past L
        active = lo < hi
        mid = (lo + hi) // 2
        v = torch.gather(w, 1, torch.clamp(mid, max=L - 1))
        go_hi = active & (v < want)
        lo = torch.where(go_hi, mid + 1, lo)
        hi = torch.where(active & ~go_hi, mid, hi)
    imax = torch.full((), INT_MAX, dtype=torch.int32, device=w.device)
    at = torch.where(lo < L, torch.gather(w, 1, torch.clamp(lo, max=L - 1)), imax)
    before = torch.where(lo > 0, torch.gather(w, 1, torch.clamp(lo - 1, 0, L - 1)), imax)
    return at, before


def _displacement(at: torch.Tensor, before: torch.Tensor, want: torch.Tensor):
    """(nearest displacement f32, whether any position exists) per lane."""
    wf = want.to(torch.float32)
    d = torch.minimum((at.to(torch.float32) - wf).abs(), (before.to(torch.float32) - wf).abs())
    return d, (at != INT_MAX) | (before != INT_MAX)


def phrase_freqs(
    post_docs: torch.Tensor,   # i32 [P_pad] doc-sorted postings (flat)
    pos_flat: torch.Tensor,    # i32 [PP_pad] flat positions (CSR values)
    pos_offs: torch.Tensor,    # i32 [PE_pad] CSR offsets per postings entry
    term_runs: list,           # [(offset, length)] of the fixed phrase terms, in order
    req_offs: list,            # their required relative positions
    exp_runs: list,            # [(offset, length)] of the expansions (none: a plain phrase)
    exp_req: int,              # the expansion slot's required offset
    cand: torch.Tensor,        # i32 [C] candidate docs (INT_MAX padded)
    *,
    slop: int,
    steps: int,                # binary-search rounds over postings runs
    win_steps: int,            # L: the window length (a power of two)
) -> torch.Tensor:
    """Phrase frequency per candidate doc (i32 [C]); pads give 0."""
    L = win_steps
    dev = cand.device

    def window_for(off, ln):
        pos, found = _search_entries(post_docs, off, ln, cand, steps)
        return _gather_window(pos_flat, pos_offs, off + pos, found, L)

    imax = torch.full((), INT_MAX, dtype=torch.int32, device=dev)
    imax1 = torch.full((), INT_MAX - 1, dtype=torch.int32, device=dev)
    w0 = window_for(*term_runs[0])
    base = torch.where(w0 != INT_MAX, w0 - int(req_offs[0]), imax)  # [C, L] anchors
    base_valid = base != INT_MAX

    def want_at(off):
        return torch.where(base_valid, base + int(off), imax1)

    ewins = [window_for(o, n) for o, n in exp_runs]
    if slop == 0:
        ok = base_valid
        for t in range(1, len(term_runs)):
            want = want_at(req_offs[t])
            at, _ = _window_lookup(window_for(*term_runs[t]), want)
            ok = ok & (at == want)
        if ewins:
            want = want_at(exp_req)
            any_m = torch.zeros_like(base_valid)
            for ew in ewins:
                at, _ = _window_lookup(ew, want)
                any_m = any_m | (at == want)
            ok = ok & any_m
        return ok.sum(dim=1, dtype=torch.int32)

    # sloppy: each non-anchor slot's nearest-position displacement, summed
    # and held to the slop (the host loop's greedy rule)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    total = torch.zeros(base.shape, dtype=torch.float32, device=dev)
    ok = base_valid
    for t in range(1, len(term_runs)):
        want = want_at(req_offs[t])
        d, has = _displacement(*_window_lookup(window_for(*term_runs[t]), want), want)
        total = total + torch.where(has, d, inf)
        ok = ok & has
    if ewins:
        want = want_at(exp_req)
        best = torch.full(base.shape, float("inf"), dtype=torch.float32, device=dev)
        for ew in ewins:
            d, has = _displacement(*_window_lookup(ew, want), want)
            best = torch.minimum(best, torch.where(has, d, inf))
        total = total + best
        ok = ok & torch.isfinite(best)
    ok = ok & (total <= float(slop))
    return ok.sum(dim=1, dtype=torch.int32)


def phrase_scatter(freqs: torch.Tensor, cand: torch.Tensor, doc_lens: torch.Tensor,
                   sum_idf, boost, k1, b, avgdl) -> tuple[torch.Tensor, torch.Tensor]:
    """Phrase-freq BM25 scores scattered to dense [D] (scores, match). The
    constants round to f32 and go as 0-d tensors on the device."""
    dev = doc_lens.device
    sum_idf, boost, k1, b, avgdl = (scalar_f32(x, dev) for x in (sum_idf, boost, k1, b, avgdl))
    D = doc_lens.shape[0]
    real = (cand < D) & (freqs > 0)
    f = freqs.to(torch.float32)
    dl = doc_lens[torch.where(real, cand, torch.zeros_like(cand)).long()]
    norm = 1.0 - b + b * dl / avgdl
    denom = (k1.double() * norm.double() + f.double()).float()
    val = boost * sum_idf * (f / denom)
    # real candidates are distinct docs; everything else goes to a dump
    # slot past the segment, so no two writes that are kept collide
    dst = torch.where(real, cand, torch.full_like(cand, D)).long()
    scores = torch.zeros(D + 1, dtype=torch.float32, device=dev)
    scores[dst] = val
    match = torch.zeros(D + 1, dtype=torch.bool, device=dev)
    match[dst] = real
    return scores[:D], match[:D]


# ---------------------------------------------------------------------------
# Host-side driver: device-position cache + padding
# ---------------------------------------------------------------------------


def device_positions(tfi):
    """A field's position CSR on its postings' device, uploaded on the first
    call and cached on the field index: (pos_flat i32 [pow2], pos_offs i32
    [pow2], entry_lens host i32), or None when the field kept no positions.
    Offsets past 2^31 - 1 raise ``ValueError``: they do not fit the int32
    offsets the windows gather with."""
    if tfi.positions is None or tfi.position_offsets is None:
        return None
    cached = getattr(tfi, "_device_pos", None)
    if cached is not None:
        return cached
    if len(tfi.position_offsets) and int(tfi.position_offsets[-1]) > INT_MAX:
        raise ValueError(
            f"{int(tfi.position_offsets[-1])} positions in one field: the device "
            f"phrase path takes at most {INT_MAX}"
        )
    dev = tfi.doc_ids.device
    flat = np.full(_pow2(max(len(tfi.positions), 1)), INT_MAX, np.int32)
    flat[: len(tfi.positions)] = tfi.positions
    offs = np.zeros(_pow2(len(tfi.position_offsets)), np.int32)
    offs[: len(tfi.position_offsets)] = tfi.position_offsets
    entry_lens = np.diff(tfi.position_offsets).astype(np.int32)
    out = (torch.as_tensor(flat, device=dev), torch.as_tensor(offs, device=dev), entry_lens)
    object.__setattr__(tfi, "_device_pos", out)
    return out


def max_positions(tfi, entry_lens: np.ndarray, terms) -> int:
    """The largest per-entry position count over the given terms."""
    m = 1
    for t in terms:
        tid = tfi.terms.get(t)
        if tid is None:
            continue
        off, ln = int(tfi.offsets[tid]), int(tfi.lengths[tid])
        if ln:
            m = max(m, int(entry_lens[off : off + ln].max()))
    return m


def _pad_candidates(cand_ids, dev: torch.device) -> torch.Tensor:
    """Candidates (host array or device tensor) as i32 [pow2 >= 128] on
    ``dev``, INT_MAX padded."""
    n = len(cand_ids)
    cand = torch.full((_pow2(n, minimum=128),), INT_MAX, dtype=torch.int32, device=dev)
    cand[:n] = torch.as_tensor(cand_ids, device=dev).to(torch.int32)
    return cand


def run_phrase(tfi, cand_ids, terms: list, req_offsets: list, slop: int, *,
               expansions: list = (), exp_req: int = 0):
    """Phrase freq over the candidates on the field's device. Returns
    (freqs i32 [C_pad], cand i32 [C_pad]) as device tensors, INT_MAX
    padded and aligned, or None when the device path cannot run (no
    positions, or no fixed anchor term). ``cand_ids`` is a host array or a
    device tensor of doc ids."""
    dev = device_positions(tfi)
    if dev is None or not terms:
        return None
    pos_flat, pos_offs, entry_lens = dev
    cand = _pad_candidates(cand_ids, tfi.doc_ids.device)
    lk = [tfi.lookup(t) for t in terms]
    elk = [(o, ln) for o, ln in (tfi.lookup(t) for t in expansions) if ln]
    if any(ln == 0 for _, ln in lk) or (expansions and not elk):
        # a missing term, or an expansion slot with no surviving
        # expansions, matches nothing
        return torch.zeros(cand.shape, dtype=torch.int32, device=cand.device), cand
    L = _pow2(max_positions(tfi, entry_lens, list(terms) + list(expansions)), minimum=8)
    max_df = max([ln for _, ln in lk] + [ln for _, ln in elk] + [2])
    steps = int(np.ceil(np.log2(max_df))) + 1
    freqs = phrase_freqs(
        tfi.doc_ids, pos_flat, pos_offs, lk, list(req_offsets), elk, int(exp_req), cand,
        slop=int(slop), steps=steps, win_steps=L,
    )
    return freqs, cand
