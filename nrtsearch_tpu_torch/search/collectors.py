"""Aggregation collectors and facets on torch tensors (counterpart:
nrtsearch_tpu/search/collectors.py).

Collectors run beside recall over the full match set: the query's
per-segment (scores, match) arrays drive masked reductions over doc-value
columns. Single-valued columns reduce on the device the segments live on
(ordinal counts by ``torch.bincount``, masked sums, minima, maxima and range
counts): only the small results leave the device. Multi-valued CSR columns,
hierarchies and exact-f64 columns reduce on the host, as in the reference.

The reference's reductions are jitted XLA programs (no Pallas kernel), so
plain torch is their port. Counts, minima and maxima equal the reference's;
an f32 masked sum adds in another order than XLA's and agrees to f32
rounding. Script sources run through ``script.expr`` on the segment's
device.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Optional

import numpy as np
import torch

from nrtsearch_tpu_torch.core.searcher import Searcher
from nrtsearch_tpu_torch.schema.fields import DocValueKind

def _host(x) -> np.ndarray:
    """A mask or score array on the host: an explicit copy for a tensor
    (``np.asarray`` refuses a CUDA tensor)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _on(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, device=device)


class SegmentMatches:
    """Per-segment match masks + scores for the current query.

    Masks stay on the device; collectors that count there (ordinal terms,
    numeric stats, hit counts, range counts) never copy the [D] masks to the
    host. ``.masks``/``.scores`` copy them lazily for the host-side
    collectors (multi-valued CSR, hierarchies)."""

    def __init__(self, searcher: Searcher, masks, scores=None):
        self.searcher = searcher
        self.raw_masks = list(masks)
        self.raw_scores = list(scores) if scores is not None else None
        self._masks = None
        self._scores = None

    @property
    def masks(self) -> list[np.ndarray]:
        if self._masks is None:
            self._masks = [_host(m) for m in self.raw_masks]
        return self._masks

    @property
    def scores(self) -> Optional[list[np.ndarray]]:
        if self.raw_scores is None:
            return None
        if self._scores is None:
            self._scores = [_host(s) for s in self.raw_scores]
        return self._scores

    def and_mask(self, other_masks) -> "SegmentMatches":
        return SegmentMatches(
            self.searcher,
            [_mask(m, seg.device) & _mask(o, seg.device) for m, o, seg in
             zip(self.raw_masks, other_masks, self.searcher.segments)],
            self.raw_scores,
        )


def _mask(m, device: torch.device) -> torch.Tensor:
    return _on(m, device).to(torch.bool)


def _iter_field_values(seg, field: str):
    """Yields (local_doc_ids, values) covering all values incl. multi-valued."""
    dv = seg.doc_values.get(field)
    if dv is None:
        return None
    if dv.mv_offsets is not None:
        docs = np.repeat(np.arange(seg.num_docs), np.diff(dv.mv_offsets))
        vals = dv.mv_values
        if dv.kind == DocValueKind.ORDINAL:
            return docs, vals, dv.ord_terms
        return docs, vals, None
    present = dv.host_present[: seg.num_docs]
    docs = np.nonzero(present)[0]
    vals = dv.host_values[: seg.num_docs][present]
    if dv.kind == DocValueKind.ORDINAL:
        return docs, vals, dv.ord_terms
    return docs, vals, None


# the reference's one-hot width limit, above which a fused reduction leaves
# an ordinal column to terms_counts (it decides which entries of a plan
# return None)
_ONEHOT_MAX_ORDS = 512


def _ordinal_counts(eff: torch.Tensor, values: torch.Tensor, n_ords: int) -> torch.Tensor:
    """Per-ordinal counts of the docs in ``eff`` ([n_ords] int64)."""
    return torch.bincount(values[eff].long(), minlength=n_ords)[:n_ords]


def _device_ordinal_counts(mask, dv) -> np.ndarray:
    """Per-ordinal match counts on the device; copies [n_ords] back, not [D]."""
    n_ords = max(len(dv.ord_terms), 1)
    eff = _mask(mask, dv.values.device) & dv.present
    return _ordinal_counts(eff, dv.values, n_ords).cpu().numpy()


def _masked_stat(eff: torch.Tensor, vals: torch.Tensor, op: str) -> torch.Tensor:
    """The reference's f32 stat of a fused reduction: sum, min or max over
    ``eff`` (0, +inf or -inf when it is empty)."""
    v = vals.to(torch.float32)
    if op == "sum":
        return torch.where(eff, v, 0.0).sum()
    if op == "min":
        return torch.where(eff, v, float("inf")).min()
    return torch.where(eff, v, float("-inf")).max()


def _reduce_step(specs, mask: torch.Tensor, arrays) -> list:
    """specs: ('ordinal', n_ords) | ('stat', op) | ('count',). ``arrays``
    holds (values, present) pairs for ordinal/stat entries in spec order.
    Returns the flat list of per-spec results (stats with their counts), on
    the host."""
    outs = []
    i = 0
    for sp in specs:
        if sp[0] == "ordinal":
            vals, present = arrays[i], arrays[i + 1]
            i += 2
            outs.append(_ordinal_counts(mask & present, vals, sp[1]))
        elif sp[0] == "stat":
            vals, present = arrays[i], arrays[i + 1]
            i += 2
            eff = mask & present
            outs.append(_masked_stat(eff, vals, sp[1]))
            outs.append(eff.sum())
        else:  # count
            outs.append(mask.sum())
    return [o.cpu().numpy() for o in outs]


def fused_flat_reductions(matches: SegmentMatches, plan: list[dict]):
    """Execute a list of flat reductions in one pass per segment.

    ``plan`` entries: {"kind": "ordinal"|"stat"|"count", "field": ...,
    "op": "sum"|"min"|"max"}. Returns per-entry results matching
    terms_counts / numeric_stat / hit_count semantics. Entries whose columns
    are ineligible on ANY segment (multi-valued, f64, non-ordinal terms)
    return None — the caller falls back to the standalone path for those.
    """
    n = len(plan)
    term_acc: list[dict] = [defaultdict(int) for _ in range(n)]
    stat_acc: list[list[float]] = [[] for _ in range(n)]
    count_acc = [0] * n
    eligible = [True] * n
    for si, seg in enumerate(matches.searcher.segments):
        specs = []
        arrays = []
        seg_slots = []
        for pi, p in enumerate(plan):
            if not eligible[pi]:
                continue
            if p["kind"] == "count":
                specs.append(("count",))
                seg_slots.append(pi)
                continue
            dv = seg.doc_values.get(p["field"])
            if dv is None:
                continue  # no values in this segment: contributes nothing
            if dv.mv_offsets is not None or dv.values.dtype == torch.float64:
                eligible[pi] = False
                continue
            if p["kind"] == "ordinal":
                if dv.kind != DocValueKind.ORDINAL or not dv.ord_terms or (
                    len(dv.ord_terms) > _ONEHOT_MAX_ORDS
                ):
                    eligible[pi] = False
                    continue
                specs.append(("ordinal", len(dv.ord_terms)))
            else:
                specs.append(("stat", p["op"]))
            arrays.append(dv.values)
            arrays.append(dv.present)
            seg_slots.append(pi)
        if not specs:
            continue
        out = _reduce_step(specs, _mask(matches.raw_masks[si], seg.device), arrays)
        oi = 0
        for sp, pi in zip(specs, seg_slots):
            if sp[0] == "ordinal":
                counts = out[oi]
                oi += 1
                terms = seg.doc_values[plan[pi]["field"]].ord_terms
                for o in np.nonzero(counts)[0]:
                    term_acc[pi][terms[int(o)]] += int(counts[o])
            elif sp[0] == "stat":
                stat, cnt = out[oi], out[oi + 1]
                oi += 2
                if int(cnt):
                    stat_acc[pi].append(float(stat))
            else:
                count_acc[pi] += int(out[oi])
                oi += 1
    results = []
    for pi, p in enumerate(plan):
        if not eligible[pi]:
            results.append(None)
        elif p["kind"] == "ordinal":
            results.append(dict(term_acc[pi]))
        elif p["kind"] == "stat":
            vals = stat_acc[pi]
            if not vals:
                results.append(0.0)
            elif p["op"] == "sum":
                results.append(float(np.sum(vals)))
            else:
                results.append(float(
                    np.min(vals) if p["op"] == "min" else np.max(vals)
                ))
        else:
            results.append(count_acc[pi])
    return results


def terms_counts(
    matches: SegmentMatches, field: str
) -> dict[str, int]:
    """Count of each term value among matching docs (TermsCollectorManager)."""
    out: dict[Any, int] = defaultdict(int)
    for i, seg in enumerate(matches.searcher.segments):
        dv = seg.doc_values.get(field)
        if dv is None:
            continue
        if (
            dv.mv_offsets is None
            and dv.kind == DocValueKind.ORDINAL
            and dv.ord_terms
        ):
            counts = _device_ordinal_counts(matches.raw_masks[i], dv)
            for o in np.nonzero(counts)[0]:
                out[dv.ord_terms[int(o)]] += int(counts[o])
            continue
        it = _iter_field_values(seg, field)
        if it is None:
            continue
        docs, vals, ord_terms = it
        mask = matches.masks[i]
        hit = mask[: seg.num_docs][docs]
        if not hit.any():
            continue
        vals = np.asarray(vals)[hit]
        uniq, counts = np.unique(vals, return_counts=True)
        for v, c in zip(uniq, counts):
            key = ord_terms[int(v)] if ord_terms is not None else _fmt_num(v)
            out[key] += int(c)
    return dict(out)


def _fmt_num(v) -> str:
    v = v.item() if hasattr(v, "item") else v
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


def _device_masked_stat(eff: torch.Tensor, vals: torch.Tensor, op: str) -> Optional[float]:
    """Masked sum/min/max + count in one device round trip; None if no docs
    matched. A sum accumulates in f64: each value fits f32 exactly, but a
    sum over millions of large values (epoch millis, counters) exceeds the
    f32 mantissa."""
    v = vals.to(torch.float32)
    if op == "sum":
        stat = torch.where(eff, v, 0.0).to(torch.float64).sum()
    else:
        stat = _masked_stat(eff, v, op)
    stat, cnt = torch.stack([stat.to(torch.float64), eff.sum().to(torch.float64)]).tolist()
    return float(stat) if int(cnt) else None


def numeric_stat(
    matches: SegmentMatches, field: str, op: str,
    script_source: Optional[str] = None,
) -> float:
    """sum/min/max over a doc-value column or a script among matching docs.

    Single-valued f32 columns and script expressions reduce on the device
    (the mask never leaves it); multi-valued CSR and exact-f64 columns keep
    the host path."""
    agg: list[float] = []
    for i, seg in enumerate(matches.searcher.segments):
        if script_source is not None:
            from nrtsearch_tpu_torch.query.eval import _ScriptDocValues
            from nrtsearch_tpu_torch.script.expr import compile_expression

            vals = compile_expression(script_source)(
                _ScriptDocValues(seg),
                torch.zeros(seg.capacity, dtype=torch.float32, device=seg.device),
            )
            eff = _mask(matches.raw_masks[i], seg.device) & (
                torch.arange(seg.capacity, device=seg.device) < seg.num_docs
            )
            vals = torch.as_tensor(vals, dtype=torch.float32, device=seg.device).expand(
                seg.capacity)
            v = _device_masked_stat(eff, vals, op)
            if v is not None:
                agg.append(v)
            continue
        dv = seg.doc_values.get(field)
        if dv is None:
            continue
        if dv.mv_offsets is None and dv.values.dtype != torch.float64:
            eff = _mask(matches.raw_masks[i], dv.values.device) & dv.present
            v = _device_masked_stat(eff, dv.values, op)
            if v is not None:
                agg.append(v)
            continue
        it = _iter_field_values(seg, field)
        if it is None:
            continue
        docs, vals, ord_terms = it
        hit = matches.masks[i][: seg.num_docs][docs]
        vals = np.asarray(vals, dtype=np.float64)[hit]
        if len(vals):
            agg.extend(
                [float(vals.sum() if op == "sum" else vals.min() if op == "min" else vals.max())]
            )
    if not agg:
        return 0.0
    if op == "sum":
        return float(np.sum(agg))
    return float(np.min(agg) if op == "min" else np.max(agg))


def hit_count(matches: SegmentMatches) -> int:
    """Matching-doc count, reduced on the device (masks are already bounded
    by live/doc-range, so padding never counts)."""
    return int(sum(int(_on(m, seg.device).sum()) for m, seg in
                   zip(matches.raw_masks, matches.searcher.segments)))


def hierarchy_counts(
    matches: SegmentMatches, field: str, path: list[str]
) -> tuple[dict[str, int], int]:
    """Hierarchical facet counts: children one level below ``path`` for
    '/'-separated values (reference: taxonomy facets with
    FacetHierarchyPath; HIERARCHY facet type).

    Returns (child label -> doc count, total docs under path)."""
    depth = len(path)
    out: dict[str, int] = defaultdict(int)
    total = 0
    for seg, mask in zip(matches.searcher.segments, matches.masks):
        it = _iter_field_values(seg, field)
        if it is None:
            continue
        docs, vals, ord_terms = it
        if ord_terms is None:
            continue
        hit = mask[: seg.num_docs][docs]
        if not hit.any():
            continue
        # per-doc dedupe of child labels (a doc counts once per child)
        seen: dict[int, set] = {}
        for doc, v in zip(docs[hit], np.asarray(vals)[hit]):
            parts = ord_terms[int(v)].split("/")
            if depth and parts[: depth] != path:
                continue
            if len(parts) <= depth:
                continue
            seen.setdefault(int(doc), set()).add(parts[depth])
        for doc, labels in seen.items():
            total += 1
            for label in labels:
                out[label] += 1
    return dict(out), total


def numeric_range_counts(
    matches: SegmentMatches, field: str, ranges: list[dict]
) -> list[tuple[str, int]]:
    """Numeric-range facet counts (reference: NumericRangeType, search.proto).
    On a single-valued f32 column the bounds compare in f32, as the
    reference's weakly typed Python floats do."""
    out = []
    for r in ranges:
        lo = float(r.get("min", -np.inf))
        hi = float(r.get("max", np.inf))
        lo_inc = bool(r.get("minInclusive", True))
        hi_inc = bool(r.get("maxInclusive", False))
        count = 0
        for i, seg in enumerate(matches.searcher.segments):
            dv = seg.doc_values.get(field)
            if dv is None:
                continue
            if dv.mv_offsets is None and dv.values.dtype != torch.float64:
                v = dv.values
                sel = (v >= lo if lo_inc else v > lo) & (
                    v <= hi if hi_inc else v < hi
                )
                eff = _mask(matches.raw_masks[i], v.device) & dv.present & sel
                count += int(eff.sum())
                continue
            it = _iter_field_values(seg, field)
            if it is None:
                continue
            docs, vals, _ = it
            vals = np.asarray(vals, dtype=np.float64)
            sel = (vals >= lo if lo_inc else vals > lo) & (
                vals <= hi if hi_inc else vals < hi
            )
            # count matching DOCS (dedupe multi-valued hits per doc)
            mask = matches.masks[i]
            hit_docs = np.unique(docs[sel & mask[: seg.num_docs][docs]])
            count += len(hit_docs)
        out.append((r.get("label", ""), count))
    return out
