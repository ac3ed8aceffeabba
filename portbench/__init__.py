"""The benchmark of ``nrtsearch_tpu_torch`` on one NVIDIA H100: the
harness, the traffic generator, the plain BM25 reference, the peaks and
the metric readers. See README.md."""
