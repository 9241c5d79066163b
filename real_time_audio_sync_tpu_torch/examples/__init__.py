"""The example scripts of the repository's ``examples/`` on the port.

``live_demo`` (the terminal live follower with its click track),
``heatmap_overlay`` (accumulated-cost heatmaps with the committed paths)
and ``mic_smoke`` (the hardware-microphone check).  Each runs as
``python -m real_time_audio_sync_tpu_torch.examples.<name>`` and has
``main(argv=None) -> int``; each takes ``--device`` (default ``cuda``),
where the JAX scripts take ``--interpret`` or nothing.
"""

from __future__ import annotations


def require_device(name: str):
    """The torch device ``--device`` names.  A CUDA device on a machine
    without one ends the script with a message naming CUDA: the scripts
    never carry on on the CPU unless asked to."""
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"error: --device {name} needs a CUDA device and torch.cuda.is_available() is false; "
            "pass --device cpu to run the plain PyTorch versions")
    return device
