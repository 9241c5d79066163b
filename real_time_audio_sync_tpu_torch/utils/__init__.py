from real_time_audio_sync_tpu_torch.utils.wavio import load_wav  # noqa: F401
