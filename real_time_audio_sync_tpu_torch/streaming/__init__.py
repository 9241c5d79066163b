from real_time_audio_sync_tpu_torch.streaming.runtime import HopFramer, ScoreFollower, WTWFollower  # noqa: F401
from real_time_audio_sync_tpu_torch.streaming.writer import AudioWriter, combine_buffers, write_wave_file  # noqa: F401
