"""On-device audio frontend: raw PCM → log-mel features as jnp ops.

A host framer (C++ FFT) costs a host round trip per chunk before the
device can decode. Here framing runs ON the device, inside the same jit
as the decoder, so audio-in→states-out is ONE dispatch:

* windowing is a strided gather over the pre-emphasized extended chunk;
* the 512-point real FFT of each 400-sample frame is TWO matmuls
  against fixed cos/sin DFT tables — at speech shapes a matmul DFT
  (160×400 @ 400×257) vectorizes over every frame in the chunk, where a
  serial butterfly chain is latency-bound;
* the mel filterbank is one more (257 → n_mels) matmul; power + log
  fuse into it.

Feature math matches :class:`pytorch_hmm_tpu.native.NativeFramer`
(pre-emphasis, Hann window, zero-padded rFFT power, triangular mel
bank, log with 1e-10 floor) — the native C++ path remains available as
the no-JAX-on-host option; see reference ``streaming.py:183-265`` for
the decode semantics this frontend feeds.

Streaming alignment: a chunk carries ``F·hop`` new samples; the framer
keeps a ``lag·hop + 1``-sample tail (``lag = ceil((frame_len−hop)/hop)``,
2 at the 400/160 default) so emitted frame ``j`` covers the global
samples ``[j·hop, j·hop + frame_len)`` — the same frame grid as the
native framer, delayed by ``lag`` frames (a frame is emitted once its
last sample has arrived). The first chunk's first ``lag`` outputs
correspond to windows before the stream start and are dropped by
:class:`DeviceFramer`.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "framing_tables",
    "device_frames",
    "DeviceFramer",
    "make_pcm_decode_step",
]


def _mel_weights(sample_rate, n_fft, n_mels) -> np.ndarray:
    """Triangular mel filterbank ``(n_mels, n_fft//2+1)`` — the same
    bank as ``NativeFramer._numpy_mel_weights`` / ``native/framer.cpp``."""
    def hz2mel(h):
        return 2595.0 * np.log10(1.0 + h / 700.0)

    def mel2hz(m):
        return 700.0 * (10 ** (m / 2595.0) - 1.0)

    n_bins = n_fft // 2 + 1
    mmin, mmax = hz2mel(0.0), hz2mel(sample_rate / 2)
    centers = mel2hz(
        mmin + (mmax - mmin) * np.arange(n_mels + 2) / (n_mels + 1)
    )
    freqs = np.arange(n_bins) * sample_rate / n_fft
    W = np.zeros((n_mels, n_bins), np.float32)
    for m in range(n_mels):
        lo, mid, hi = centers[m], centers[m + 1], centers[m + 2]
        up = (freqs - lo) / (mid - lo)
        down = (hi - freqs) / (hi - mid)
        W[m] = np.maximum(0.0, np.minimum(up, down))
    return W


def framing_tables(
    sample_rate: int = 16000,
    n_fft: int = 512,
    frame_len: int = 400,
    hop: int = 160,
    n_mels: int = 80,
) -> dict:
    """Constant tables for :func:`device_frames` (build once, close over).

    ``cos``/``sin`` are the real-DFT analysis tables ``(frame_len,
    n_bins)`` — columns k of ``cos(2πkn/n_fft)`` over the UNPADDED
    window length (zero padding contributes nothing to the dot), and
    ``mel`` is the filterbank transposed to ``(n_bins, n_mels)``.
    """
    n_bins = n_fft // 2 + 1
    n = np.arange(frame_len)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    window = (
        0.5 - 0.5 * np.cos(2 * np.pi * np.arange(frame_len) / (frame_len - 1))
    ).astype(np.float32)
    return {
        "cos": jnp.asarray(np.cos(ang), jnp.float32),
        "sin": jnp.asarray(-np.sin(ang), jnp.float32),
        "window": jnp.asarray(window),
        "mel_t": jnp.asarray(_mel_weights(sample_rate, n_fft, n_mels).T),
        "frame_len": frame_len,
        "hop": hop,
        "lag": -(-(frame_len - hop) // hop),
    }


def device_frames(
    tail: jax.Array,
    chunk: jax.Array,
    tables: dict,
    preemphasis: float = 0.97,
) -> Tuple[jax.Array, jax.Array]:
    """One chunk of on-device framing: ``(new_tail, (F, n_mels) log-mels)``.

    Args:
        tail: ``(lag·hop + 1,)`` trailing samples from the previous chunk
            (zeros at stream start).
        chunk: ``(F·hop,)`` new PCM samples.
    Pure and jit-composable — fuse it into the decode step
    (:func:`make_pcm_decode_step`) so audio→states is one dispatch.
    """
    frame_len, hop = tables["frame_len"], tables["hop"]
    F = chunk.shape[0] // hop
    ext = jnp.concatenate([tail, chunk])
    y = ext[1:] - preemphasis * ext[:-1]             # ((F+lag)·hop,)
    # Overlapped framing WITHOUT a gather: y[j·hop : j·hop+frame_len]
    # for all j is q full hop-rows plus an r-sample head of the next
    # row (frame_len = q·hop + r), so frames assemble from q+1
    # CONTIGUOUS slices of the (F+lag, hop) reshape: plain windowed
    # copies in place of an (F, frame_len) advanced-index gather.
    rows = y.reshape(-1, hop)
    q, r = divmod(frame_len, hop)
    parts = [rows[i:F + i] for i in range(q)]
    if r:
        parts.append(rows[q:F + q, :r])
    frames = jnp.concatenate(parts, axis=1) * tables["window"]
    # Real-input DFT as two matmuls; HIGHEST so the spectrum matches
    # the f32 FFT reference (the tables are tiny; the cost is ~µs).
    re = jnp.dot(frames, tables["cos"],
                 precision=jax.lax.Precision.HIGHEST)
    im = jnp.dot(frames, tables["sin"],
                 precision=jax.lax.Precision.HIGHEST)
    power = re * re + im * im                        # (F, n_bins)
    logmel = jnp.log(
        jnp.dot(power, tables["mel_t"],
                precision=jax.lax.Precision.HIGHEST) + 1e-10
    )
    new_tail = ext[chunk.shape[0]:]
    return new_tail, logmel


class DeviceFramer:
    """Streaming wrapper with :class:`~pytorch_hmm_tpu.native.NativeFramer`
    ``push``/``pop`` semantics, computing on the JAX default device.

    Feed any sample count; frames are emitted in ``F·hop`` chunks (the
    jitted program is shaped by ``chunk_frames``, default 160 = 1.6 s of
    10 ms hops... 160 frames per pop at the streaming demo's chunking).
    Emitted frame ``j`` covers samples ``[j·hop, j·hop+frame_len)`` —
    identical windows to the native framer.
    """

    def __init__(
        self,
        sample_rate: int = 16000,
        n_fft: int = 512,
        frame_len: int = 400,
        hop: int = 160,
        n_mels: int = 80,
        preemphasis: float = 0.97,
        chunk_frames: int = 160,
    ):
        self.tables = framing_tables(
            sample_rate, n_fft, frame_len, hop, n_mels
        )
        self.hop = hop
        self.frame_len = frame_len
        self.n_mels = n_mels
        self.preemphasis = preemphasis
        self.chunk_frames = chunk_frames
        self._step = jax.jit(
            functools.partial(
                device_frames, tables=self.tables, preemphasis=preemphasis
            )
        )
        self.reset()

    def reset(self):
        lag = self.tables["lag"]
        self._tail = jnp.zeros((lag * self.hop + 1,), jnp.float32)
        self._pending = np.zeros((0,), np.float32)
        self._skip = lag  # pre-stream windows from the zero tail

    def push(self, samples) -> int:
        samples = np.ascontiguousarray(samples, np.float32).ravel()
        self._pending = np.concatenate([self._pending, samples])
        return len(samples)

    def pop(self, max_frames: int = 1 << 14) -> np.ndarray:
        """Drain ready frames → ``(n, n_mels)`` float32 log-mels."""
        out = []
        got = 0
        span = self.chunk_frames * self.hop
        while len(self._pending) >= span and got < max_frames:
            chunk = jnp.asarray(self._pending[:span])
            self._pending = self._pending[span:]
            self._tail, feats = self._step(self._tail, chunk)
            feats = np.asarray(feats)
            if self._skip:
                feats = feats[self._skip:]
                self._skip = 0
            out.append(feats)
            got += len(feats)
        if not out:
            return np.zeros((0, self.n_mels), np.float32)
        return np.concatenate(out)[:max_frames]

    @property
    def is_native(self) -> bool:  # API parity with NativeFramer
        return False


def make_pcm_decode_step(
    processor,
    chunk_frames: int = 160,
    sample_rate: int = 16000,
    n_fft: int = 512,
    frame_len: int = 400,
    hop: int = 160,
    preemphasis: float = 0.97,
):
    """Fuse framing + emission + beam decode into ONE jitted device step.

    Returns ``(step, carry0)`` where ``step(carry, pcm_chunk)`` takes
    ``(F·hop,)`` raw samples and returns ``(carry, states (F,), conf
    (F,), n_valid)`` — the audio-in→states-out path of the streaming
    demo as a single device dispatch (no host framer, no per-stage round
    trips). Only ``states[:n_valid]`` are meaningful: the first chunk
    yields ``n_valid = F − lag`` states (``lag`` = 2 at the 400/160
    default) because the ``lag`` leading windows would start before the
    stream and are dropped — exactly the frame grid
    :class:`DeviceFramer` emits, so decoded state ``j`` always covers
    the global samples ``[j·hop, j·hop + frame_len)``. Every later
    chunk has ``n_valid = F``. ``processor`` is a
    :class:`~pytorch_hmm_tpu.streaming.StreamingHMMProcessor` (its
    emission MLP + transitions + beam carry shapes are captured by
    value at call time).
    """
    from .streaming import _beam_step, _emit, _PAD_GRANULE

    tables = framing_tables(
        sample_rate, n_fft, frame_len, hop, processor.feature_dim
    )
    w = (
        processor.emission_hidden.kernel[...],
        processor.emission_hidden.bias[...],
        processor.emission_out.kernel[...],
        processor.emission_out.bias[...],
    )
    log_a = jnp.log(processor.get_transition_matrix() + 1e-8)
    beam0 = (
        processor._beam_scores, processor._beam_states,
        processor._beam_paths, processor._beam_len,
    )
    lag = tables["lag"]
    tail0 = jnp.zeros((lag * hop + 1,), jnp.float32)
    carry0 = (tail0, jnp.int32(lag), beam0)
    pad = -(-chunk_frames // _PAD_GRANULE) * _PAD_GRANULE - chunk_frames

    @jax.jit
    def step(carry, pcm_chunk):
        tail, skip, beam = carry
        tail, feats = device_frames(tail, pcm_chunk, tables, preemphasis)
        # Drop the pre-stream windows of the first chunk: roll the valid
        # frames to the front and decode only n_valid of them, so the
        # beam history never sees the zero-tail synthetics.
        feats = jnp.roll(feats, -skip, axis=0)
        n_valid = jnp.int32(chunk_frames) - skip
        if pad:
            feats = jnp.pad(feats, ((0, pad), (0, 0)))
        lo = _emit(feats, *w)
        beam, states, conf = _beam_step(log_a, lo, n_valid, beam)
        return (
            (tail, jnp.zeros_like(skip), beam),
            states[:chunk_frames], conf[:chunk_frames], n_valid,
        )

    return step, carry0
