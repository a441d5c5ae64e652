"""pytorch_hmm_tpu — HMM speech-processing framework in JAX.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of
``crlotwhite/pytorch_hmm``: log-domain HMM inference, GMM/neural emission
models, explicit-duration HSMMs, streaming decoding, DTW/CTC alignment and
speech metrics — scan/associative-scan recursions, Pallas-Triton trellis
kernels on the GPU, SPMD sharding over device meshes, static shapes
throughout.

The public API mirrors the reference package's surface
(``pytorch_hmm/__init__.py:101-175``) so reference users can migrate
without relearning names, and adds the distributed layer
(``pytorch_hmm_tpu.parallel``) the reference lacks.

Unlike the reference, importing this package has **no side effects** (the
reference runs ``auto_configure()`` at import, ``__init__.py:476-477``);
call :func:`pytorch_hmm_tpu.auto_configure` explicitly if desired.

The functional core imports with JAX, NumPy and optax alone. The flax
``nnx`` model classes, the streaming processors and the transition
toolbox load on first use and need flax.
"""

from __future__ import annotations

__version__ = "0.1.0"

from . import alignment, checkpoint, core, durations, metrics, ops, parallel, profiling
from .alignment import (
    ConstrainedDTWAligner,
    CTCAligner,
    CTCSegmentationAligner,
    DTWAligner,
    ctc_alignment_path,
    dtw_alignment,
)
from .checkpoint import (
    load_checkpoint,
    restore_streaming_session,
    save_checkpoint,
    streaming_session_state,
)
from .logging_utils import MetricsLogger, get_logger
from .native import NativeFramer, native_available
from .profiling import benchmark_op, device_time, trace
from .api import (
    Config,
    KOREAN_PHONEMES,
    ModelFactory,
    auto_configure,
    check_optional_dependencies,
    config,
    create_korean_tts_hmm,
    create_speech_hmm,
    get_device_info,
    get_speech_transitions,
    run_quick_test,
)
from .hmm import HMM, HMMJax, HMMPyTorch
from .metrics import (
    alignment_accuracy,
    boundary_accuracy,
    comprehensive_speech_evaluation,
    duration_accuracy,
    f0_root_mean_square_error,
    log_f0_rmse,
    mel_cepstral_distortion,
    perceptual_evaluation_speech_quality,
    print_evaluation_summary,
    save_evaluation_results,
    spectral_distortion,
)
from ._lazy import lazy_getattr

_FLAX_MODULES = {
    ".models": (
        "AdaptiveDurationHSMM", "ContextualNeuralHMM",
        "DurationConstrainedHMM", "DurationModel", "GaussianHMMLayer",
        "HMMLayer", "HSMMLayer", "MixtureGaussianHMMLayer", "NeuralHMM",
        "NeuralObservationModel", "NeuralTransitionModel", "SemiMarkovHMM",
    ),
    ".streaming": (
        "AdaptiveLatencyController", "MultiStreamDecoder",
        "StreamingHMMProcessor", "StreamingResult",
    ),
    ".utils": (
        "AdaptiveTransitionMatrix", "AttentionTransition",
        "align_sequences", "analyze_transition_patterns",
        "benchmark_transition_operations", "compute_state_durations",
        "create_attention_based_transitions",
        "create_duration_constrained_matrix",
        "create_gaussian_observation_model",
        "create_hierarchical_transitions", "create_left_to_right_matrix",
        "create_phoneme_aware_transitions",
        "create_prosody_aware_transitions", "create_skip_state_matrix",
        "create_transition_matrix", "gaussian_log_likelihood",
        "interpolate_features", "optimize_transition_matrix",
        "validate_transition_matrix",
    ),
}
__getattr__ = lazy_getattr(__name__, {
    **{name: mod for mod, names in _FLAX_MODULES.items() for name in names},
    **{mod[1:]: mod for mod in (*_FLAX_MODULES, ".demo", ".frontend")},
})


def get_version() -> str:
    """Package version (``__init__.py:379-381``)."""
    return __version__


__all__ = [
    "__version__",
    "get_version",
    # core classes
    "HMM",
    "HMMJax",
    "HMMPyTorch",
    # submodules
    "core",
    "durations",
    "alignment",
    "metrics",
    "parallel",
    "ops",
    "checkpoint",
    "profiling",
    # checkpoint / profiling helpers
    "save_checkpoint",
    "load_checkpoint",
    "streaming_session_state",
    "restore_streaming_session",
    "device_time",
    "benchmark_op",
    "trace",
    # native frontend
    "NativeFramer",
    "native_available",
    # logging
    "get_logger",
    "MetricsLogger",
    # model layers
    "HMMLayer",
    "GaussianHMMLayer",
    "MixtureGaussianHMMLayer",
    "HSMMLayer",
    "DurationConstrainedHMM",
    "DurationModel",
    "SemiMarkovHMM",
    "AdaptiveDurationHSMM",
    "NeuralTransitionModel",
    "NeuralObservationModel",
    "NeuralHMM",
    "ContextualNeuralHMM",
    # streaming
    "StreamingHMMProcessor",
    "MultiStreamDecoder",
    "StreamingResult",
    "AdaptiveLatencyController",
    # alignment
    "DTWAligner",
    "ConstrainedDTWAligner",
    "CTCAligner",
    "CTCSegmentationAligner",
    "dtw_alignment",
    "ctc_alignment_path",
    # metrics
    "mel_cepstral_distortion",
    "f0_root_mean_square_error",
    "log_f0_rmse",
    "alignment_accuracy",
    "boundary_accuracy",
    "duration_accuracy",
    "spectral_distortion",
    "perceptual_evaluation_speech_quality",
    "comprehensive_speech_evaluation",
    "print_evaluation_summary",
    "save_evaluation_results",
    # api / config / factories
    "Config",
    "config",
    "create_speech_hmm",
    "create_korean_tts_hmm",
    "get_speech_transitions",
    "ModelFactory",
    "KOREAN_PHONEMES",
    "get_device_info",
    "run_quick_test",
    "check_optional_dependencies",
    "auto_configure",
    # transition toolbox
    "AdaptiveTransitionMatrix",
    "AttentionTransition",
    "align_sequences",
    "analyze_transition_patterns",
    "benchmark_transition_operations",
    "compute_state_durations",
    "create_attention_based_transitions",
    "create_duration_constrained_matrix",
    "create_gaussian_observation_model",
    "create_hierarchical_transitions",
    "create_left_to_right_matrix",
    "create_phoneme_aware_transitions",
    "create_prosody_aware_transitions",
    "create_skip_state_matrix",
    "create_transition_matrix",
    "gaussian_log_likelihood",
    "interpolate_features",
    "optimize_transition_matrix",
    "validate_transition_matrix",
]
