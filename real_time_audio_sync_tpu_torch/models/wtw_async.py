"""The block helpers of the JAX package's ``models/wtw_async.py`` (:53-97)
that the fused WTW engine shares: one dispatch's sample span or host chroma
columns.  The scalar-slot layout of the WTW engines' state (:90-95) is
``ops/wtw_insert.WS_*``.

The ``AsyncWTW`` engine itself (the plain block step as an engine, for
windows above 128 frames and for float64) is not ported yet: ROADMAP.md
Queue 1, item 7c.
"""

from __future__ import annotations

import numpy as np

from real_time_audio_sync_tpu_torch.features.chroma import host_chroma_frames


def build_span(fifo, k: int, k_block: int, hop: int, fft: int, dtype) -> np.ndarray:
    """One block's contiguous sample span from a ``SampleFIFO``, consuming
    its ``k·hop`` samples.  Always the static ``(k_block−1)·hop + fft``
    samples (a ragged tail zero-padded; the padded columns are past
    ``n_valid``) and always a copy: the FIFO's storage is mutated in place
    by ``consume``/``extend`` while a copy to the card may still read it."""
    span_len = (k_block - 1) * hop + fft
    avail = fifo.view((k - 1) * hop + fft)
    if avail.shape[0] < span_len:
        span = np.zeros(span_len, dtype)
        span[: avail.shape[0]] = avail
    else:
        span = np.array(avail, dtype, copy=True)
    fifo.consume(k * hop)
    return span


def host_chroma_block(fifo, k: int, k_block: int, hop: int, fft: int, dtype) -> np.ndarray:
    """One block's (12, k_block) chroma columns extracted on the host,
    consuming the block's ``k·hop`` samples (``transfer_dtype="chroma"``);
    the span and consumption of :func:`build_span`."""
    span = build_span(fifo, k, k_block, hop, fft, dtype)
    stride = span.strides[0]
    frames = np.lib.stride_tricks.as_strided(span, shape=(k_block, fft), strides=(hop * stride, stride))
    return host_chroma_frames(frames, n_fft=fft)
