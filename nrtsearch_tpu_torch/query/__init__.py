"""Query side of the port (counterpart: nrtsearch_tpu/query/).

``parse_query`` turns a proto-JSON-shaped query dict into plan nodes
(``plan.py``, the port's own copy of the reference's backend-free parser)."""

from nrtsearch_tpu_torch.query.plan import parse_query

__all__ = ["parse_query"]
