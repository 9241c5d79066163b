"""OnlineTimeWarping — Dixon-2005 online DTW (reference otw_eran.py:5-239;
the JAX package's ``models/otw.py``), on tensors.

API parity: ``OnlineTimeWarping(ref, {'c': .., 'max_run_count': ..})`` with
``.insert(col) -> None | "stop"``, ``.set_live(live)``, ``.path``.

Engine-specific semantics against LiveNote (SURVEY.md §7 hard part 2):
uncomputed-cell sentinel 1e10 (otw_eran.py:27) and run_count initialized to 1
(otw_eran.py:33); after ``set_live`` the path is a numpy array
(otw_eran.py:142), after streaming inserts a list of tuples.
"""

from __future__ import annotations

from real_time_audio_sync_tpu_torch.models.online_core import ENGINE_OVERRIDES, BandedOnlineEngine


class OnlineTimeWarping(BandedOnlineEngine):
    def __init__(self, ref, params, dtype=None, exact_chain=False, *, device="cuda"):
        super().__init__(
            ref,
            params,
            dict(ENGINE_OVERRIDES["otw"]),
            dtype=dtype,
            exact_chain=exact_chain,
            reset_on_set_live=True,  # otw_eran.py:92-97
            device=device,
        )

    def set_live(self, live):
        super().set_live(live)
        return None  # the reference stores the path on the instance only

    @property
    def path(self):
        if self._batch_mode:
            return self.path_array  # np.array(self.path) at otw_eran.py:142
        return super().path

    @property
    def c(self):
        return self.cfg.c

    @property
    def max_run_count(self):
        return self.cfg.max_run_count
