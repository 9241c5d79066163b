"""Multi-stream serving: ``FusedMultiStreamFollower`` over the K-insert
kernel's grid of B streams, ``FusedMultiStreamWTW`` over the WTW kernel's,
and their status polling; ``MultiStreamFollower`` over the online tensor
engine's batched step, and ``MultiStreamWTW`` over ``AsyncWTW``'s block
step with its windows batched through the wavefront kernels; ``pad_pairs``
and ``batched_set_live`` align a batch of song pairs in one call.  Each
takes ``mesh=`` (``corpus_mesh``, ``mesh.Mesh``) to split its streams or
pairs over several devices, or over one device several times;
``sharded_chroma_frames`` splits the feature frontend's frames."""

from real_time_audio_sync_tpu_torch.parallel.corpus import (  # noqa: F401
    batched_set_live,
    corpus_mesh,
    pad_pairs,
    sharded_chroma_frames,
)
from real_time_audio_sync_tpu_torch.parallel.serving import (  # noqa: F401
    FusedMultiStreamFollower,
    MultiStreamFollower,
)
from real_time_audio_sync_tpu_torch.parallel.wtw_serving import FusedMultiStreamWTW, MultiStreamWTW  # noqa: F401
