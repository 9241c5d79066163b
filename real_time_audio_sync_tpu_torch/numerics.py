"""Numerics policy of the port, in one place.

The alignment recurrences break ties with strict ``<`` on float32 costs,
so the matmuls that feed them must round as full float32 does: TF32 keeps
about three decimal digits and flips DP ties (docs/PARITY.md §13).
PyTorch leaves float32 matmuls in full precision by default but runs
float32 convolutions through cuDNN in TF32, so both switches are turned
off here, explicitly and once for the process.  The package's
``__init__`` imports this module, so the policy holds before any matmul of
the port runs.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
