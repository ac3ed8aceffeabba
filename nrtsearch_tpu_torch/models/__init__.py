"""Synthetic corpora for the port's smoke run and tests."""
