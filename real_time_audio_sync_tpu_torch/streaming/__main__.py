"""``python -m real_time_audio_sync_tpu_torch.streaming``: the live app
(``streaming/app.py``)."""

import sys

from real_time_audio_sync_tpu_torch.streaming.app import main

if __name__ == "__main__":  # importing the module (a package walk) runs nothing
    sys.exit(main())
