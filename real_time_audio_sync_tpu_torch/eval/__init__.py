from real_time_audio_sync_tpu_torch.eval.ground_truth import GroundTruth, get_beat, get_beat_wtw  # noqa: F401
from real_time_audio_sync_tpu_torch.eval.logs import parse_field_log, path_from_field_log, write_field_log  # noqa: F401
from real_time_audio_sync_tpu_torch.eval.scorer import PathScorer, ScoreResult  # noqa: F401
