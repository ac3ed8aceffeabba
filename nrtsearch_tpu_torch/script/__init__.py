"""Scripting: the js-expression subset, compiled to torch operations
(counterpart: nrtsearch_tpu/script/).

Reference equivalent: server/script/ (ScriptService with ScoreScript,
FacetScript and RuntimeScript contexts, whose built-in engine is Lucene's
javascript expression compiler). The expression runs vectorized over a
whole segment's doc-value columns at once.
"""

from nrtsearch_tpu_torch.script.expr import compile_expression

__all__ = ["compile_expression"]
