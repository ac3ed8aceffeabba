"""Segments, the writer, the packed field view, the merge-path index and
the Searcher of the port (counterparts in nrtsearch_tpu/core/)."""
