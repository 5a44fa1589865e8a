"""The synthetic LM data stream and its prefetcher: the port's copies of
``repro/data/``."""
