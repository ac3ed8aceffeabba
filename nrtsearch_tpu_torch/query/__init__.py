"""Query side of the port (counterpart: nrtsearch_tpu/query/).

Query parsing is backend-neutral and shared with the reference:
``parse_query`` turns a proto-JSON-shaped query dict into plan nodes
(nrtsearch_tpu/query/plan.py, which imports neither jax nor torch)."""

from nrtsearch_tpu.query.plan import parse_query

__all__ = ["parse_query"]
