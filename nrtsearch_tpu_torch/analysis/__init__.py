"""Copy of ``nrtsearch_tpu/analysis/__init__.py``, kept whole: the port imports
nothing of the JAX package, not even its backend-free modules.

Text analysis: tokenizers, token filters, analyzers.

Host-side mirror of the reference's analysis layer (reference:
server/analysis/AnalyzerCreator.java, analysis.proto:36-76). Analysis runs on
the host during indexing and query parsing; only packed postings reach the
device.

The chain model matches the reference's proto: char filters -> tokenizer ->
token filters, with predefined analyzers by name and custom chains built from
parts. Filters are plain Python callables ``list[Token] -> list[Token]`` so
plugins can register more (the reference's server/plugins.py does).
"""

from nrtsearch_tpu_torch.analysis.analyzers import (
    Analyzer,
    AnalyzerRegistry,
    Token,
    get_analyzer,
    register_analyzer,
)

__all__ = [
    "Analyzer",
    "AnalyzerRegistry",
    "Token",
    "get_analyzer",
    "register_analyzer",
]
