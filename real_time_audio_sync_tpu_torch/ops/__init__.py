"""Hand-written CUDA kernels (sources in ``csrc/``) and their plain PyTorch versions."""

from real_time_audio_sync_tpu_torch.ops.otw_set_live import pallas_batched_set_live, pallas_set_live  # noqa: F401
from real_time_audio_sync_tpu_torch.ops.wavefront import (  # noqa: F401
    DTW_SPEC,
    WTW_SPEC,
    StepSpec,
    backtrack,
    wavefront_dp,
)
