"""In-package feature demo — the ``pytorch-hmm-tpu-demo`` console script.

Compact tour of the model families and alignment tools, mirroring the
reference's demo script (``examples/advanced_features_demo.py``; console
script ``pytorch-hmm-demo``, reference ``pyproject.toml:119-121``). The
reference wires its entry point at ``examples.advanced_features_demo``,
which is not an installed package — here the demo lives inside the
library so the script resolves after ``pip install``. The fuller
narrated walk-throughs remain in ``examples/``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def main() -> None:
    """Run the demo tour. Raises on the first failing section, so the
    ``pytorch-hmm-tpu-demo`` console script exits non-zero then and 0 on
    success. Needs flax."""
    from flax import nnx

    print("=" * 60)
    print("pytorch_hmm_tpu feature demo")
    print(f"backend: {jax.default_backend()}  devices: {jax.devices()}")
    print("=" * 60)
    key = jax.random.PRNGKey(0)

    # 1. Core HMM: posteriors + Viterbi on a left-to-right topology.
    from .hmm import HMM
    from .utils import create_left_to_right_matrix

    hmm = HMM(create_left_to_right_matrix(6))
    obs = jax.random.uniform(key, (2, 50, 6))
    gamma, _, _ = hmm.forward_backward(obs)
    states, score = hmm.viterbi_decode(obs)
    print(f"[1] HMM: posteriors {gamma.shape}, Viterbi paths "
          f"{states.shape}, log-prob {np.asarray(score).round(1)}")

    # 2. GMM-HMM decode (the flagship serving path).
    from .models import MixtureGaussianHMMLayer

    gmm = MixtureGaussianHMMLayer(
        num_states=8, feature_dim=40, num_components=2,
        rngs=nnx.Rngs(0),
    )
    feats = jax.random.normal(key, (4, 100, 40))
    st, ll = gmm(feats, return_log_probs=True)
    dec = gmm.make_decoder()          # parameter-frozen serving decoder
    st2, _ = dec(feats, return_log_probs=True)
    assert np.array_equal(np.asarray(st), np.asarray(st2))
    print(f"[2] GMM-HMM: decoded {st.shape}, serving decoder matches "
          f"(mean ll {float(jnp.mean(ll)):.1f})")

    # 3. HSMM: explicit duration modeling + generation.
    from .models import HSMMLayer

    hsmm = HSMMLayer(
        num_states=5, feature_dim=40, max_duration=12,
        rngs=nnx.Rngs(0),
    )
    seg, _ = hsmm.viterbi_decode_hsmm(feats)
    exp_dur = hsmm.get_expected_durations()
    print(f"[3] HSMM: segmentation {seg.shape}, expected durations "
          f"{np.asarray(exp_dur).round(1)}")

    # 4. NeuralHMM: context-dependent time-varying transitions.
    from .models import NeuralHMM

    nh = NeuralHMM(
        num_states=6, observation_dim=40, hidden_dim=64,
        rngs=nnx.Rngs(0),
    )
    nh.eval()
    gamma_n, _, _ = nh(feats[:1])   # probability-space posteriors
    print(f"[4] NeuralHMM: posteriors {gamma_n.shape} "
          f"(rows sum to {float(gamma_n[0, 0].sum()):.3f})")

    # 5. Alignment: DTW and CTC forced alignment.
    from .alignment import dtw_alignment, ctc_viterbi_alignment

    x = jax.random.normal(key, (60, 40))
    y = x[jnp.repeat(jnp.arange(60), 2)[:100]]  # stretched copy
    path_i, path_j, cost = dtw_alignment(x, y)
    lp = jax.nn.log_softmax(jax.random.normal(key, (80, 1, 20)), -1)
    tgt = jax.random.randint(key, (1, 10), 1, 20)
    ali, sc = ctc_viterbi_alignment(
        lp, tgt, jnp.array([80]), jnp.array([10])
    )
    print(f"[5] DTW path {len(path_i)} steps (cost {float(cost):.1f}); "
          f"CTC alignment {ali.shape} (score {float(sc[0]):.1f})")

    # 6. Streaming: chunked low-latency decode with carried state.
    from .streaming import StreamingHMMProcessor

    proc = StreamingHMMProcessor(
        num_states=6, feature_dim=40, chunk_size=20,
        lookahead_frames=0, use_beam_search=True, rngs=nnx.Rngs(0),
    )
    for c in range(4):
        chunk = jax.random.normal(jax.random.PRNGKey(c), (20, 40))
        res = proc.process_chunk(chunk)
    stats = proc.get_performance_stats()
    print(f"[6] Streaming: 4 chunks, last status '{res.status}', "
          f"last-chunk latency "
          f"{stats.get('min_processing_time_ms', 0):.2f} ms "
          f"(first chunk pays the jit compile)")

    # 7. Speech metrics.
    from .metrics import mel_cepstral_distortion

    mcd = mel_cepstral_distortion(feats[0, :, :13], feats[1, :, :13])
    print(f"[7] Metrics: MCD {float(mcd):.2f} dB")

    print("=" * 60)
    print("demo complete — see examples/ for the narrated versions")


if __name__ == "__main__":
    main()
