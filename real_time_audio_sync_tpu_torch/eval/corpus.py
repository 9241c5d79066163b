"""Corpus evaluation defaults (reference tests.py:140).

Only the engine parameters the live follower defaults to are ported so far;
the pair and corpus drivers of the JAX package's ``eval/corpus.py`` are a
later slice (ROADMAP.md, Queue 1).
"""

DEFAULT_PARAMS = {"search_band_width": 50, "max_run_count": 3}  # tests.py:140
