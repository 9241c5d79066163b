"""LiveNoteV2 — LiveNote plus path monotonicity and chroma-diff cost
(reference livenote_v2.py:3-236; the JAX package's
``models/livenote_v2.py``), on tensors.

A best point is appended only when strictly forward in live and
non-backward in ref (livenote_v2.py:197-199); with ``chroma_diff=True`` the
cell cost is the Euclidean distance between (rectified chroma-diff) feature
columns instead of the cosine cost (livenote_v2.py:167-170).

Engine selection caveat (measured by the JAX package, its
docs/ACCURACY.md): ``chroma_diff=True`` trades noise robustness for tacet
robustness — best through silence and dropout passages, but it collapses
under heavy broadband noise or detune.  Use the default cosine cost for
noisy capture chains.
"""

from __future__ import annotations

from real_time_audio_sync_tpu_torch.models.online_core import ENGINE_OVERRIDES, BandedOnlineEngine


class LiveNoteV2(BandedOnlineEngine):
    def __init__(self, ref, params, debug_params=None, chroma_diff=False, dtype=None, exact_chain=False, *,
                 device="cuda"):
        del debug_params  # accepted-but-unused, reference parity
        super().__init__(
            ref,
            params,
            dict(ENGINE_OVERRIDES["livenote_v2_diff" if chroma_diff else "livenote_v2"]),
            dtype=dtype,
            exact_chain=exact_chain,
            device=device,
        )
        self.chroma_diff = bool(chroma_diff)

    @property
    def search_band_width(self):
        return self.cfg.c

    @property
    def max_run_count(self):
        return self.cfg.max_run_count
