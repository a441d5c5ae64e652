"""Real-time streaming HMM decoding.

Parity target: reference ``streaming.py`` — ``StreamingHMMProcessor``
(chunked low-latency decoding with a feature ring buffer, lookahead,
greedy or beam search carrying decoder state across chunks, async thread
wrapper, perf stats, latency auto-tuning) plus
``AdaptiveLatencyController`` and the ``StreamingResult`` dataclass.

Design (SURVEY.md §7 principle 4):

* the decoder step is a **pure jit-compiled function**
  ``(carry, features) → (carry, outputs)`` with an explicit, fixed-shape
  carry pytree (previous Viterbi state / fixed-width beam hypotheses) —
  the reference mutates Python lists per frame inside ``torch.no_grad``
  (``streaming.py:267-377``);
* beam search is fixed-width ``top_k`` over a ``(W·S)`` score table per
  frame, with a rolling ``(W, H)`` path history buffer — static shapes,
  no Python hypothesis lists (``streaming.py:322-377``);
* variable-length chunks are padded to a frame-granularity bucket so XLA
  compiles a small, fixed set of step programs;
* ``get_latency_breakdown`` reports **measured** emission vs decode
  times, not hardcoded percentages (``streaming.py:485-503``).

The async wrapper stays a thin host-side thread + queue pair, exactly as
in the reference (``streaming.py:123-181``) — it is IO plumbing, not
compute.
"""

from __future__ import annotations

import functools
import queue
import threading
import time
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from flax import nnx

__all__ = [
    "StreamingResult",
    "StreamingHMMProcessor",
    "MultiStreamDecoder",
    "AdaptiveLatencyController",
]


@dataclass
class StreamingResult:
    """Per-chunk processing result (``streaming.py:23-32``)."""

    decoded_states: Optional[jax.Array]
    confidence: float
    processing_time_ms: float
    buffer_size: int
    chunk_id: int
    status: str
    metadata: Dict[str, Any] = field(default_factory=dict)


# Frame-granularity bucket for padded jit steps: every processed span is
# padded up to a multiple of this, bounding the number of compiled programs.
_PAD_GRANULE = 32


class StreamingHMMProcessor(nnx.Module):
    """Streaming chunked HMM decoder (``streaming.py:35-503``)."""

    def __init__(
        self,
        num_states: int,
        feature_dim: int,
        chunk_size: int = 160,          # 10 ms @ 16 kHz
        overlap_size: int = 80,
        lookahead_frames: int = 5,
        max_delay_frames: int = 50,
        use_beam_search: bool = True,
        beam_width: int = 8,
        buffer_size: int = 1000,
        *,
        rngs: Optional[nnx.Rngs] = None,
    ):
        rngs = rngs or nnx.Rngs(0)
        self.num_states = num_states
        self.feature_dim = feature_dim
        self.chunk_size = chunk_size
        self.overlap_size = overlap_size
        self.lookahead_frames = lookahead_frames
        self.max_delay_frames = max_delay_frames
        self.use_beam_search = use_beam_search
        self.beam_width = min(beam_width, num_states)
        self.buffer_size = buffer_size

        self.transition_logits = nnx.Param(
            jax.random.normal(rngs.params(), (num_states, num_states)) * 0.1
        )
        self.emission_hidden = nnx.Linear(feature_dim, 128, rngs=rngs)
        self.emission_out = nnx.Linear(128, num_states, rngs=rngs)

        self.reset_streaming_state()

        # Performance monitoring (host-side).
        self.processing_times: deque = deque(maxlen=1000)
        self.emission_times: deque = deque(maxlen=1000)
        self.decode_times: deque = deque(maxlen=1000)
        self.chunk_counter = 0
        self.total_frames_processed = 0

        # Async plumbing (thin host-side wrapper, streaming.py:123-181).
        self.processing_queue: queue.Queue = queue.Queue(maxsize=buffer_size)
        self.result_queue: queue.Queue = queue.Queue(maxsize=buffer_size)
        self.is_processing = False
        self.processing_thread: Optional[threading.Thread] = None

    # -- state ---------------------------------------------------------------
    def reset_streaming_state(self):
        """Reset all carried decoder state (``streaming.py:102-117``)."""
        self._buffer = np.zeros((0, self.feature_dim), np.float32)
        self.last_output_frame = -1
        self.frames_dropped = 0
        self.chunk_counter = 0
        self.total_frames_processed = 0
        # Greedy carry: previous state + validity flag.
        self._prev_state = jnp.zeros((), jnp.int32)
        self._has_prev = jnp.zeros((), jnp.bool_)
        # Beam carry: (W,) scores, (W,) last states, (W, H) rolling paths,
        # scalar path length. H covers the longest decodable span (a full
        # buffer flush).
        W = self.beam_width
        H = (
            max(self.max_delay_frames, self.chunk_size)
            + self.lookahead_frames
        )
        init = -jnp.log(jnp.asarray(float(self.num_states)))
        self._beam_scores = jnp.where(
            jnp.arange(W) < self.num_states, init, -jnp.inf
        )
        self._beam_states = jnp.arange(W, dtype=jnp.int32) % self.num_states
        self._beam_paths = jnp.zeros((W, H), jnp.int32)
        self._beam_len = jnp.zeros((), jnp.int32)

    # -- parameter views ------------------------------------------------------
    def get_transition_matrix(self) -> jax.Array:
        return jax.nn.softmax(self.transition_logits[...], axis=-1)

    def _emission_log_probs(self, features: jax.Array) -> jax.Array:
        h = jax.nn.relu(self.emission_hidden(features))
        return jax.nn.log_softmax(self.emission_out(h), axis=-1)

    # -- async wrapper ---------------------------------------------------------
    def start_async_processing(self):
        if self.is_processing:
            return
        self.is_processing = True
        self.processing_thread = threading.Thread(
            target=self._async_processing_loop, daemon=True
        )
        self.processing_thread.start()

    def stop_async_processing(self):
        self.is_processing = False
        if self.processing_thread:
            self.processing_thread.join()

    def _async_processing_loop(self):
        while self.is_processing:
            try:
                chunk = self.processing_queue.get(timeout=0.1)
                result = self.process_chunk(chunk)
                if not self.result_queue.full():
                    self.result_queue.put(result)
                self.processing_queue.task_done()
            except queue.Empty:
                continue
            except Exception as e:  # pragma: no cover - defensive
                warnings.warn(f"Error in async processing: {e}")

    def add_audio_chunk_async(self, audio_chunk) -> bool:
        """Enqueue a chunk; ``False`` when back-pressured
        (``streaming.py:160-174``)."""
        try:
            self.processing_queue.put_nowait(audio_chunk)
            return True
        except queue.Full:
            return False

    def get_result_async(self) -> Optional[StreamingResult]:
        try:
            return self.result_queue.get_nowait()
        except queue.Empty:
            return None

    # -- synchronous path -------------------------------------------------------
    def process_chunk(self, audio_chunk) -> StreamingResult:
        """Process one ``(chunk, feature_dim)`` block
        (``streaming.py:183-265``)."""
        start_time = time.perf_counter()
        chunk = np.asarray(audio_chunk, np.float32)
        self._buffer = np.concatenate([self._buffer, chunk], axis=0)
        # Bound the buffer. The reference caps it at max_delay + lookahead
        # (streaming.py:104), which with the default chunk_size=160 >
        # max_delay=50 can never reach the `chunk + lookahead` frames
        # required to decode — a latent deadlock we do not reproduce: the
        # cap must admit at least one decodable span.
        max_buf = max(
            self.max_delay_frames + self.lookahead_frames,
            self.chunk_size + self.lookahead_frames,
        )
        if len(self._buffer) > max_buf:
            drop = len(self._buffer) - max_buf
            self._buffer = self._buffer[drop:]
            self.last_output_frame -= drop
            self.frames_dropped += drop

        available = len(self._buffer)
        required = self.chunk_size + self.lookahead_frames
        if available < required:
            ms = (time.perf_counter() - start_time) * 1e3
            return StreamingResult(
                None, 0.0, ms, available, self.chunk_counter, "buffering",
                {"frames_needed": required - available},
            )

        start_frame = max(0, self.last_output_frame + 1)
        end_frame = available - self.lookahead_frames
        if end_frame <= start_frame:
            ms = (time.perf_counter() - start_time) * 1e3
            return StreamingResult(
                None, 0.0, ms, available, self.chunk_counter,
                "waiting_for_lookahead", {},
            )

        features = self._buffer[start_frame:end_frame]
        states, confidence = self._decode_span(features)

        self.last_output_frame = end_frame - 1
        self.total_frames_processed += len(features)
        ms = (time.perf_counter() - start_time) * 1e3
        self.processing_times.append(ms)
        self.chunk_counter += 1

        frame_ms = len(features) * 10.0  # 100 fps features
        rtf = frame_ms / ms if ms > 0 else float("inf")
        return StreamingResult(
            states,
            float(jnp.mean(confidence)) if confidence is not None else 0.0,
            ms,
            available,
            self.chunk_counter,
            "decoded",
            {
                "frames_processed": len(features),
                "real_time_factor": rtf,
                "buffer_utilization": available / max_buf,
            },
        )

    def _decode_span(self, features: np.ndarray):
        """Pad to a bucket, run the jitted step, trim, update carry."""
        n = len(features)
        padded = -((-n) // _PAD_GRANULE) * _PAD_GRANULE
        feats = np.zeros((padded, self.feature_dim), np.float32)
        feats[:n] = features
        feats = jnp.asarray(feats)

        t0 = time.perf_counter()
        log_obs = _emit(
            feats,
            self.emission_hidden.kernel[...], self.emission_hidden.bias[...],
            self.emission_out.kernel[...], self.emission_out.bias[...],
        )
        log_obs.block_until_ready()
        t1 = time.perf_counter()

        log_a = jnp.log(self.get_transition_matrix() + 1e-8)
        if self.use_beam_search:
            carry = (self._beam_scores, self._beam_states,
                     self._beam_paths, self._beam_len)
            new_carry, states_pad, conf_pad = _beam_step(
                log_a, log_obs, jnp.int32(n), carry
            )
            (self._beam_scores, self._beam_states,
             self._beam_paths, self._beam_len) = new_carry
        else:
            carry = (self._prev_state, self._has_prev)
            new_carry, states_pad, conf_pad = _greedy_step(
                log_a, log_obs, jnp.int32(n), carry
            )
            self._prev_state, self._has_prev = new_carry
        states_pad.block_until_ready()
        t2 = time.perf_counter()
        self.emission_times.append((t1 - t0) * 1e3)
        self.decode_times.append((t2 - t1) * 1e3)
        return states_pad[:n], conf_pad[:n]

    def flush_buffer(self) -> Optional[StreamingResult]:
        """Decode everything left in the buffer (``streaming.py:379-407``)."""
        start_frame = max(0, self.last_output_frame + 1)
        if len(self._buffer) == 0 or start_frame >= len(self._buffer):
            return None
        features = self._buffer[start_frame:]
        states, confidence = self._decode_span(features)
        self.last_output_frame = len(self._buffer) - 1
        self.total_frames_processed += len(features)
        self.chunk_counter += 1
        return StreamingResult(
            states, float(jnp.mean(confidence)), 0.0, 0, self.chunk_counter,
            "flushed", {"final_chunk": True},
        )

    # -- performance ------------------------------------------------------------
    def get_performance_stats(self) -> Dict[str, Any]:
        """(``streaming.py:409-442``)."""
        if not self.processing_times:
            return {"message": "No processing data available"}
        times = list(self.processing_times)
        avg = sum(times) / len(times)
        frame_ms = self.chunk_size * 10.0
        return {
            "total_chunks_processed": self.chunk_counter,
            "total_frames_processed": self.total_frames_processed,
            "avg_processing_time_ms": avg,
            "max_processing_time_ms": max(times),
            "min_processing_time_ms": min(times),
            "std_processing_time_ms": float(np.std(times)),
            "real_time_factor": frame_ms / avg if avg > 0 else float("inf"),
            "throughput_fps": (
                self.total_frames_processed / (sum(times) / 1e3)
                if times else 0.0
            ),
            "buffer_utilization": len(self._buffer)
            / max(
                self.max_delay_frames + self.lookahead_frames,
                self.chunk_size + self.lookahead_frames,
            ),
            "chunk_size": self.chunk_size,
            "lookahead_frames": self.lookahead_frames,
            "beam_width": self.beam_width if self.use_beam_search else 1,
            "processing_mode": (
                "beam_search" if self.use_beam_search else "greedy"
            ),
        }

    def optimize_for_latency(self, target_latency_ms: float = 50.0):
        """Auto-tune beam width / mode / chunk size
        (``streaming.py:444-483``)."""
        stats = self.get_performance_stats()
        if "avg_processing_time_ms" not in stats:
            warnings.warn("No performance data available for optimization")
            return
        current = stats["avg_processing_time_ms"]
        if current > target_latency_ms:
            if self.use_beam_search and self.beam_width > 2:
                self.beam_width -= 1
                self._resize_beam()
            elif self.use_beam_search:
                self.use_beam_search = False
            elif self.chunk_size > 80:
                self.chunk_size = max(80, int(self.chunk_size * 0.8))
        elif current < target_latency_ms * 0.5:
            if not self.use_beam_search:
                self.use_beam_search = True
                self.beam_width = min(4, self.num_states)
                self._resize_beam()
            elif self.beam_width < 8:
                self.beam_width = min(self.beam_width + 1, self.num_states)
                self._resize_beam()

    def _resize_beam(self):
        """Re-shape the beam carry after a width change, keeping the best
        existing hypotheses."""
        W = self.beam_width
        # Keep the existing history length: chunk_size may have changed
        # since the buffers were allocated, and mixing lengths would
        # break the widen-concatenate below.
        H = self._beam_paths.shape[1]
        old_w = self._beam_scores.shape[0]
        if old_w == W:
            return
        if W < old_w:
            top = jnp.argsort(-self._beam_scores)[:W]
            self._beam_scores = self._beam_scores[top]
            self._beam_states = self._beam_states[top]
            self._beam_paths = self._beam_paths[top]
        else:
            pad = W - old_w
            self._beam_scores = jnp.concatenate(
                [self._beam_scores, jnp.full((pad,), -jnp.inf)]
            )
            self._beam_states = jnp.concatenate(
                [self._beam_states, jnp.zeros((pad,), jnp.int32)]
            )
            self._beam_paths = jnp.concatenate(
                [self._beam_paths, jnp.zeros((pad, H), jnp.int32)]
            )

    def get_latency_breakdown(self) -> Dict[str, float]:
        """Measured emission/decode split — real numbers, unlike the
        reference's hardcoded percentages (``streaming.py:485-503``)."""
        if not self.processing_times:
            return {}
        total = sum(self.processing_times) / len(self.processing_times)
        emit = (
            sum(self.emission_times) / len(self.emission_times)
            if self.emission_times else 0.0
        )
        dec = (
            sum(self.decode_times) / len(self.decode_times)
            if self.decode_times else 0.0
        )
        return {
            "emission_computation": emit,
            "viterbi_decoding": dec,
            "bookkeeping": max(total - emit - dec, 0.0),
            "total": total,
        }


# ---------------------------------------------------------------------------
# Jitted decoder steps (pure; carry in, carry out)
# ---------------------------------------------------------------------------

@jax.jit
def _emit(feats, w1, b1, w2, b2):
    h = jax.nn.relu(feats @ w1 + b1)
    return jax.nn.log_softmax(h @ w2 + b2, axis=-1)


@jax.jit
def _greedy_step(log_a, log_obs, n_valid, carry):
    """Frame-greedy decoding continuing from the carried state
    (``streaming.py:267-320`` semantics: argmax per frame given the
    previous chosen state, not a full Viterbi)."""
    S = log_a.shape[0]
    prev_state, has_prev = carry

    def step(c, xs):
        prev, has, t = c
        lo_t = xs
        first = lo_t - jnp.log(jnp.asarray(float(S)))
        cont = log_a[prev] + lo_t
        scores = jnp.where(has, cont, first)
        s = jnp.argmax(scores).astype(jnp.int32)
        sc = scores[s]
        valid = t < n_valid
        new_prev = jnp.where(valid, s, prev)
        new_has = has | valid
        return (new_prev, new_has, t + 1), (s, sc)

    (prev_state, has_prev, _), (states, scores) = jax.lax.scan(
        step, (prev_state, has_prev, jnp.int32(0)), log_obs, unroll=16
    )
    return (prev_state, has_prev), states, jnp.exp(scores)


@functools.partial(jax.jit, static_argnames=("t_pad",))
def _beam_finalize(new_carry, scores_before, t_pad, n_valid):
    """Post-scan bookkeeping of the beam step:
    best-path extraction, per-span confidence, score renormalization."""
    scores, last_states, paths, path_len = new_carry
    H = paths.shape[1]
    best = jnp.argmax(scores)
    # The last n_valid decoded states live at the tail of the history.
    tail = paths[best]  # (H,)
    idx = H - n_valid + jnp.arange(t_pad)
    states = tail[jnp.clip(idx, 0, H - 1)]
    # Per-span confidence: geometric-mean probability of the frames
    # decoded in THIS chunk (score delta / n_valid), so long streams
    # don't decay it. On the first chunk score_before is the uniform
    # prior, already part of the span's joint, so the delta is the
    # whole path score as desired.
    span = scores[best] - jnp.max(scores_before)
    conf = jnp.full(
        (t_pad,),
        jnp.exp(span / jnp.maximum(n_valid, 1).astype(jnp.float32)),
    )
    # Renormalize the carried scores so they stay bounded across chunks;
    # only score differences matter to future top-k/argmax decisions.
    scores = scores - jnp.max(scores)
    return (scores, last_states, paths, path_len), states, conf


@jax.jit
def _beam_step(log_a, log_obs, n_valid, carry):
    """Fixed-width beam search with carried hypotheses
    (``streaming.py:322-377``)."""
    # Carried scores are renormalized (max-subtracted) at the end of each
    # chunk, so they never drift toward -inf on long streams; confidence
    # comes from the per-span score delta, not the unbounded joint.
    score_before = jnp.max(carry[0])
    *new_carry, _ = _beam_scan_raw(log_a, log_obs, n_valid, carry)
    return _beam_finalize(
        tuple(new_carry), score_before, log_obs.shape[0], n_valid
    )


class MultiStreamDecoder:
    """Beam-decode N concurrent streams in ONE device dispatch per
    chunk cadence — the serving-side batching the reference's
    single-stream ``StreamingHMMProcessor`` (reference
    ``streaming.py:322-377``) has no analogue of.

    The single-stream beam scan is vmapped over a leading stream axis,
    so all streams share one serial frame chain per chunk.

    Usage::

        dec = MultiStreamDecoder(processor, n_streams=8)
        carry = dec.init_carry()
        carry, states, conf = dec.step(carry, feats)   # (N, F, D) in
        # states (N, F) int32, conf (N, F) — per stream, identical to
        # running processor.process_chunk on each stream separately.

    Streams may be at different lifecycle points (per-stream history);
    chunks share one ``n_valid`` (equal-cadence serving). To retire a
    stream, reset its carry rows via ``reset_stream``.
    """

    def __init__(self, processor: "StreamingHMMProcessor",
                 n_streams: int, chunk_frames: Optional[int] = None):
        self.n = int(n_streams)
        self.chunk_frames = chunk_frames or processor.chunk_size
        self.num_states = processor.num_states
        self.beam_width = processor.beam_width
        self.history = processor._beam_paths.shape[1]
        self._w = (
            processor.emission_hidden.kernel[...],
            processor.emission_hidden.bias[...],
            processor.emission_out.kernel[...],
            processor.emission_out.bias[...],
        )
        self._log_a = jnp.log(processor.get_transition_matrix() + 1e-8)
        self._proto = (
            processor._beam_scores, processor._beam_states,
            processor._beam_paths, processor._beam_len,
        )

    def init_carry(self):
        """Stacked fresh per-stream beam carries."""
        sc, st, pt, pl_ = self._proto
        N = self.n
        return (
            jnp.broadcast_to(sc, (N, *sc.shape)),
            jnp.broadcast_to(st, (N, *st.shape)),
            jnp.broadcast_to(pt, (N, *pt.shape)),
            jnp.broadcast_to(jnp.zeros_like(pl_), (N,)),
        )

    def reset_stream(self, carry, i: int):
        """Fresh carry for stream ``i`` (session ended / new session)."""
        sc, st, pt, pl_ = self._proto
        c0, c1, c2, c3 = carry
        return (
            c0.at[i].set(sc), c1.at[i].set(st),
            c2.at[i].set(pt), c3.at[i].set(jnp.zeros_like(pl_)),
        )

    def step(self, carry, features: jax.Array, n_valid=None):
        """One chunk for every stream: ``features (N, F, D)`` →
        ``(carry, states (N, F), conf (N, F))``."""
        n_valid = (
            jnp.int32(features.shape[1]) if n_valid is None
            else jnp.asarray(n_valid, jnp.int32)
        )
        return _multi_step(
            self._log_a, self._w, n_valid, carry, features,
        )

    # -- raw-audio serving: on-device framing for every stream ---------
    def make_pcm_step(self, sample_rate=16000, n_fft=512, frame_len=400,
                      hop=160, preemphasis=0.97, feature_dim=None):
        """Whole-fleet audio→states: ``step(carry, pcm (N, F·hop))`` →
        ``(carry, states (N, F), conf (N, F), n_valid)`` as ONE device
        program — the matmul-DFT frontend (``frontend.device_frames``)
        vmaps over streams and feeds the multi-stream beam kernel.
        Returns ``(step, carry0)``; the carry stacks per-stream framer
        tails on top of :meth:`init_carry`'s beam state. Only
        ``states[:, :n_valid]`` are meaningful: the first chunk yields
        ``n_valid = F − lag`` states (the ``lag`` leading windows would
        start before the stream and are dropped, matching the
        ``DeviceFramer`` frame grid); later chunks have ``n_valid=F``.
        Streams share one skip counter (equal-cadence fleets start
        together; ``reset_stream`` resets beam state only)."""
        from .frontend import device_frames, framing_tables

        n_mels = feature_dim or self._w[0].shape[0]
        tables = framing_tables(sample_rate, n_fft, frame_len, hop, n_mels)
        lag = tables["lag"]
        F = self.chunk_frames
        tail0 = jnp.zeros((self.n, lag * hop + 1), jnp.float32)
        carry0 = (tail0, jnp.int32(lag), self.init_carry())
        log_a, w = self._log_a, self._w

        @functools.partial(jax.jit, static_argnames=())
        def step(carry, pcm):
            tails, skip, beam = carry
            tails, feats = jax.vmap(
                lambda t, c: device_frames(t, c, tables, preemphasis)
            )(tails, pcm)
            # Drop the first chunk's pre-stream windows (see
            # frontend.make_pcm_decode_step).
            feats = jnp.roll(feats, -skip, axis=1)
            n_valid = jnp.int32(F) - skip
            beam, states, conf = _multi_step(log_a, w, n_valid, beam, feats)
            return (tails, jnp.zeros_like(skip), beam), states, conf, n_valid

        return step, carry0


@jax.jit
def _multi_step(log_a, w, n_valid, carry, features):
    N, F, _D = features.shape
    lo = _emit(features.reshape(N * F, -1), *w).reshape(N, F, -1)
    pad = -(-F // _PAD_GRANULE) * _PAD_GRANULE - F
    if pad:
        lo = jnp.pad(lo, ((0, 0), (0, pad), (0, 0)))
    scores_before = carry[0]
    # The single-stream scan, vmapped over streams (bit-identical per
    # stream; renormalization happens below).
    def one(lo_n, c_n):
        sc, ls, pt, pl_, t = _beam_scan_raw(log_a, lo_n, n_valid, c_n)
        return sc, ls, pt, pl_

    new_carry = jax.vmap(one)(lo, carry)
    (fin_carry, states, conf) = jax.vmap(
        lambda c, sb: _beam_finalize(c, sb, lo.shape[1], n_valid)
    )(new_carry, scores_before)
    return fin_carry, states[:, :F], conf[:, :F]


def _beam_scan_raw(log_a, log_obs, n_valid, carry):
    """The beam scan of ``_beam_step`` without the finalize: returns the
    raw carry ``(scores, last_states, paths, path_len, frames)``."""
    scores, last_states, paths, path_len = carry
    W, H = paths.shape

    def step(c, xs):
        sc, ls, pt, pl, t = c
        lo_t = xs
        first = sc[:, None] + lo_t[None, :]                      # (W, S)
        cont = sc[:, None] + log_a[ls] + lo_t[None, :]
        table = jnp.where(pl == 0, first, cont)                  # (W, S)
        # Hypotheses in the same state are redundant (Markov property):
        # keep only the best parent per state, THEN take the top-W
        # states. A flat top_k over (W·S) would fill the beam with
        # tied duplicates of one state, silently collapsing the beam
        # to width 1.
        best_per_state = jnp.max(table, axis=0)
        parent_per_state = jnp.argmax(table, axis=0)
        top, new_state = jax.lax.top_k(best_per_state, W)
        new_state = new_state.astype(jnp.int32)
        parent = parent_per_state[new_state].astype(jnp.int32)
        new_paths = jnp.concatenate(
            [pt[parent][:, 1:], new_state[:, None]], axis=1
        )
        valid = t < n_valid
        sc = jnp.where(valid, top, sc)
        ls = jnp.where(valid, new_state, ls)
        pt = jnp.where(valid, new_paths, pt)
        pl = jnp.where(valid, jnp.minimum(pl + 1, H), pl)
        return (sc, ls, pt, pl, t + 1), None

    out, _ = jax.lax.scan(
        step, (scores, last_states, paths, path_len, jnp.int32(0)),
        log_obs, unroll=16,
    )
    return out


class AdaptiveLatencyController:
    """Feedback controller over recent chunk latencies
    (``streaming.py:506-592``)."""

    def __init__(
        self,
        initial_chunk_size: int = 160,
        min_chunk_size: int = 80,
        max_chunk_size: int = 320,
        target_latency_ms: float = 50.0,
        adaptation_rate: float = 0.1,
    ):
        self.chunk_size = initial_chunk_size
        self.min_chunk_size = min_chunk_size
        self.max_chunk_size = max_chunk_size
        self.target_latency_ms = target_latency_ms
        self.adaptation_rate = adaptation_rate
        self.latency_history: deque = deque(maxlen=100)
        self.last_adjustment_time = 0.0

    def update(
        self, processing_time_ms: float, buffer_size: int
    ) -> Dict[str, Any]:
        """Feed one latency sample; returns recommended parameter changes
        (1 s adjustment cooldown, ``streaming.py:544-546``)."""
        self.latency_history.append(processing_time_ms)
        now = time.time()
        if now - self.last_adjustment_time < 1.0:
            return {}
        if len(self.latency_history) < 10:
            return {}

        recent = list(self.latency_history)[-20:]
        avg = sum(recent) / len(recent)
        var = float(np.var(recent))
        rec: Dict[str, Any] = {}

        if avg > self.target_latency_ms * 1.2:
            if self.chunk_size > self.min_chunk_size:
                self.chunk_size = max(
                    self.min_chunk_size,
                    int(self.chunk_size * (1 - self.adaptation_rate)),
                )
                rec["chunk_size"] = self.chunk_size
            rec["beam_width"] = 3
            rec["use_beam_search"] = avg <= self.target_latency_ms * 2
        elif avg < self.target_latency_ms * 0.6 and var < 10.0:
            if self.chunk_size < self.max_chunk_size and buffer_size > 100:
                self.chunk_size = min(
                    self.max_chunk_size,
                    int(self.chunk_size * (1 + self.adaptation_rate)),
                )
                rec["chunk_size"] = self.chunk_size
            rec["beam_width"] = 6
            rec["use_beam_search"] = True
        elif var > 25.0:
            rec["use_beam_search"] = False
            self.chunk_size = max(
                self.min_chunk_size, int(self.chunk_size * 0.9)
            )
            rec["chunk_size"] = self.chunk_size

        if rec:
            self.last_adjustment_time = now
        return rec
