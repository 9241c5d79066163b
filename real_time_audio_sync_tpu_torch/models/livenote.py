"""LiveNote — the reference's product score follower (livenote.py:3-226;
the JAX package's ``models/livenote.py``), on tensors.

Same recurrence as OnlineTimeWarping with renamed parameters
(``search_band_width`` for ``c``), sentinel ``inf`` (livenote.py:19-20) and
run_count initialized to 0 (livenote.py:32).  ``debug_params`` is accepted
and unused, as in the reference (livenote.py:5).
"""

from __future__ import annotations

from real_time_audio_sync_tpu_torch.models.online_core import ENGINE_OVERRIDES, BandedOnlineEngine


class LiveNote(BandedOnlineEngine):
    def __init__(self, ref, params, debug_params=None, dtype=None, exact_chain=False, *, device="cuda"):
        del debug_params  # accepted-but-unused, reference parity
        super().__init__(
            ref,
            params,
            dict(ENGINE_OVERRIDES["livenote"]),
            dtype=dtype,
            exact_chain=exact_chain,
            device=device,
        )

    @property
    def search_band_width(self):
        return self.cfg.c

    @property
    def max_run_count(self):
        return self.cfg.max_run_count
