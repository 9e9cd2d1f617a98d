"""Byte-level tokenizer and the synthetic benchmarks (copies of
``repro.data``)."""
