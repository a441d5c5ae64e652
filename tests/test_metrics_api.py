"""Metrics + package API tests (reference coverage:
test_integration.py:213-260 for metrics, plus the factory surface)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import nnx

import pytorch_hmm_tpu as ph
from pytorch_hmm_tpu import metrics as M


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

def test_mcd_zero_for_identical():
    x = jnp.asarray(np.random.default_rng(0).normal(size=(30, 13)), jnp.float32)
    assert float(M.mel_cepstral_distortion(x, x)) == pytest.approx(0.0, abs=1e-3)


def test_mcd_known_value():
    # Constant offset of 1 in every non-c0 dim: MCD = K * sqrt(D-1)
    T, D = 10, 5
    a = jnp.zeros((T, D))
    b = jnp.ones((T, D))
    K = np.sqrt(2) * 10 / np.log(10)
    expect = K * np.sqrt(D - 1)
    assert float(M.mel_cepstral_distortion(a, b)) == pytest.approx(expect, rel=1e-4)
    # batched + c0 included
    got = M.mel_cepstral_distortion(a[None], b[None], exclude_c0=False)
    assert float(got[0]) == pytest.approx(K * np.sqrt(D), rel=1e-4)


def test_f0_rmse_voiced_only():
    f0t = jnp.asarray([100.0, 0.0, 200.0, 150.0])
    f0p = jnp.asarray([110.0, 50.0, 0.0, 150.0])
    # voiced in both: frames 0 and 3 → errors 10, 0 → rmse = sqrt(50)
    got = float(M.f0_root_mean_square_error(f0t, f0p))
    assert got == pytest.approx(np.sqrt(50.0), rel=1e-5)
    lg = float(M.log_f0_rmse(f0t, f0p, voiced_mask=jnp.asarray([1, 0, 0, 1], bool)))
    assert np.isfinite(lg)


def test_alignment_accuracy_tolerance():
    pred = jnp.asarray([0, 0, 1, 1, 2, 2])
    gt = jnp.asarray([0, 1, 1, 2, 2, 2])
    exact = float(M.alignment_accuracy(pred, gt))
    assert exact == pytest.approx(4 / 6)
    tol = float(M.alignment_accuracy(pred, gt, tolerance=1))
    assert tol >= exact


def test_boundary_metrics():
    pred = jnp.asarray([10, 20, 31, 50])
    gt = jnp.asarray([10, 21, 30])
    out = M.boundary_accuracy(pred, gt, tolerance=2)
    assert int(out["true_positives"]) == 3
    assert int(out["false_positives"]) == 1
    assert int(out["false_negatives"]) == 0
    assert float(out["recall"]) == pytest.approx(1.0)
    assert float(out["precision"]) == pytest.approx(0.75)


def test_duration_metrics():
    pred = jnp.asarray([10.0, 20.0, 30.0])
    gt = jnp.asarray([12.0, 20.0, 27.0])
    out = M.duration_accuracy(pred, gt, relative_tolerance=0.2)
    assert float(out["mae"]) == pytest.approx(5 / 3, rel=1e-4)
    assert float(out["accuracy_within_tolerance"]) == pytest.approx(1.0)
    assert float(out["correlation"]) > 0.9


@pytest.mark.parametrize("dt", ["euclidean", "cosine", "kl_divergence"])
def test_spectral_distortion_types(dt):
    rng = np.random.default_rng(1)
    a = jnp.asarray(rng.normal(size=(2, 20, 8)), jnp.float32)
    b = jnp.asarray(rng.normal(size=(2, 20, 8)), jnp.float32)
    d_ab = M.spectral_distortion(a, b, dt)
    d_aa = M.spectral_distortion(a, a, dt)
    assert d_ab.shape == (2,)
    assert (np.asarray(d_aa) <= np.asarray(d_ab) + 1e-5).all()


def test_pseudo_pesq_range():
    rng = np.random.default_rng(2)
    clean = jnp.asarray(rng.normal(size=(8000,)), jnp.float32)
    assert float(M.perceptual_evaluation_speech_quality(clean, clean)) == pytest.approx(5.0, abs=1e-3)
    noisy = clean + 2.0 * jnp.asarray(rng.normal(size=(8000,)), jnp.float32)
    score = float(M.perceptual_evaluation_speech_quality(clean, noisy))
    assert 1.0 <= score < 5.0


def test_comprehensive_and_save(tmp_path):
    rng = np.random.default_rng(3)
    gt = {
        "mfcc": jnp.asarray(rng.normal(size=(30, 13)), jnp.float32),
        "f0": jnp.abs(jnp.asarray(rng.normal(size=(30,)), jnp.float32)) * 100,
        "alignment": jnp.asarray(rng.integers(0, 4, size=(30,))),
        "boundaries": jnp.asarray([5, 15, 25]),
        "durations": jnp.asarray([5.0, 10.0, 10.0, 5.0]),
        "mel_spectrogram": jnp.asarray(rng.normal(size=(30, 20)), jnp.float32),
    }
    pred = {k: v for k, v in gt.items()}
    out = M.comprehensive_speech_evaluation(pred, gt)
    assert float(out["mcd"]) == pytest.approx(0.0, abs=1e-3)
    assert float(out["alignment_accuracy"]) == pytest.approx(1.0)
    assert float(out["boundary_f1"]) == pytest.approx(1.0)
    M.print_evaluation_summary(out)
    path = tmp_path / "metrics.json"
    M.save_evaluation_results(out, str(path))
    loaded = json.loads(path.read_text())
    assert "mcd" in loaded


# ---------------------------------------------------------------------------
# Package API / factories
# ---------------------------------------------------------------------------

def test_create_speech_hmm_dispatch():
    m1 = ph.create_speech_hmm(4, 8, "mixture_gaussian")
    assert isinstance(m1, ph.MixtureGaussianHMMLayer)
    m2 = ph.create_speech_hmm(4, 8, "hsmm", max_duration=10)
    assert isinstance(m2, ph.HSMMLayer)
    m3 = ph.create_speech_hmm(4, 8, "streaming", chunk_size=16)
    assert isinstance(m3, ph.StreamingHMMProcessor)
    with pytest.raises(ValueError, match="banana"):
        ph.create_speech_hmm(4, 8, "banana")


def test_korean_tts_factory():
    m = ph.create_korean_tts_hmm()
    assert m.num_states == len(ph.KOREAN_PHONEMES)
    assert m.feature_dim == 80


@pytest.mark.parametrize("st", ["normal", "fast", "slow", "emotional"])
def test_speech_transition_presets(st):
    P = ph.get_speech_transitions(6, st)
    assert P.shape == (6, 6)
    np.testing.assert_allclose(np.asarray(P).sum(-1), 1.0, atol=1e-5)


def test_speech_transitions_unknown():
    with pytest.raises(ValueError, match="banana"):
        ph.get_speech_transitions(6, "banana")


def test_model_factory():
    asr = ph.ModelFactory.create_asr_model(10, 40)
    assert isinstance(asr, ph.MixtureGaussianHMMLayer)
    assert asr.num_components == 4
    tts = ph.ModelFactory.create_tts_model(8, 40)
    assert isinstance(tts, ph.HSMMLayer)
    rt = ph.ModelFactory.create_realtime_model(5, 40)
    assert isinstance(rt, ph.StreamingHMMProcessor)
    assert not rt.use_beam_search


def test_device_info_and_config():
    info = ph.get_device_info()
    assert info["device_count"] >= 1
    assert "platform" in info
    cfg = ph.Config()
    assert cfg.EPS == 1e-8
    d = cfg.get_info()
    assert "device" in d and "jax_version" in d


def test_run_quick_test():
    # Raises on failure; returns None so the console script exits 0.
    assert ph.run_quick_test() is None


def test_check_optional_dependencies():
    deps = ph.check_optional_dependencies()
    assert set(deps) == {"librosa", "matplotlib", "soundfile"}


def test_auto_configure_explicit():
    from pytorch_hmm_tpu import precision

    before = (precision.mixed_precision_enabled(),
              precision.checkpointing_enabled())
    try:
        info = ph.auto_configure()
        assert info["device"] in ("cpu", "gpu")
        # On CPU, auto_configure turns mixed precision off (reference
        # behavior) — the global flag must reflect that here.
        if info["device"] == "cpu":
            assert ph.config.USE_MIXED_PRECISION is False
    finally:
        # The flags are process-global policy: restore so test order
        # doesn't leak across this xdist worker.
        precision.set_mixed_precision(before[0])
        precision.set_checkpointing(before[1])


def test_config_constructor_kwargs():
    from pytorch_hmm_tpu import precision

    before = (precision.mixed_precision_enabled(),
              precision.checkpointing_enabled())
    try:
        cfg = ph.Config(USE_MIXED_PRECISION=False, USE_CHECKPOINTING=False)
        assert cfg.USE_MIXED_PRECISION is False
        assert cfg.USE_CHECKPOINTING is False
        assert cfg.EPS == 1e-8
    finally:
        precision.set_mixed_precision(before[0])
        precision.set_checkpointing(before[1])
