"""Package-level configuration, factories and utilities.

Parity target: reference ``__init__.py:187-477`` — global ``Config``,
``create_speech_hmm`` / ``create_korean_tts_hmm`` factories, speech
transition presets, ``ModelFactory``, device info, quick test, optional
dependency probe, and ``auto_configure``.

Deliberate differences (SURVEY.md §5 "Config / flag system"):

* ``Config`` is an explicit, instantiable configuration object; the
  defaults live on a module-level singleton but **nothing runs at import
  time** — the reference calls ``auto_configure()`` on import
  (``__init__.py:476-477``), resizing global limits as a side effect.
  Call :func:`auto_configure` explicitly if you want that behavior.
* Device identity is JAX platform/mesh based; there is no device string
  to thread through model code.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import jax

from . import precision

__all__ = [
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
]


class Config:
    """Framework configuration (``__init__.py:187-226``).

    ``pytorch_hmm_tpu.config`` is the default instance.

    ``USE_MIXED_PRECISION`` and ``USE_CHECKPOINTING`` are LIVE flags
    (the reference declares them and never reads them, reference
    ``__init__.py:198-205``): they delegate to :mod:`..precision` —
    process-global state, like the reference's class-attribute Config —
    which emission scoring and gradient paths consult at trace time.
    See ``precision.py`` for semantics and error bounds. Constructing a
    ``Config`` with either flag therefore sets the global policy.
    """

    def __init__(
        self,
        EPS: float = 1e-8,
        LOG_EPS: float = math.log(1e-8),
        DEFAULT_CHUNK_SIZE: int = 1000,
        MAX_SEQUENCE_LENGTH: int = 100_000,
        USE_MIXED_PRECISION: Optional[bool] = None,
        USE_CHECKPOINTING: Optional[bool] = None,
    ):
        self.EPS = EPS
        self.LOG_EPS = LOG_EPS
        self.DEFAULT_CHUNK_SIZE = DEFAULT_CHUNK_SIZE
        # There is no hard sequence cap (long sequences shard over the
        # time axis); this mirrors the reference field for compatibility
        # and is advisory only.
        self.MAX_SEQUENCE_LENGTH = MAX_SEQUENCE_LENGTH
        if USE_MIXED_PRECISION is not None:
            precision.set_mixed_precision(USE_MIXED_PRECISION)
        if USE_CHECKPOINTING is not None:
            precision.set_checkpointing(USE_CHECKPOINTING)
        # Resolved lazily: reading the backend at import time would
        # initialize XLA before multihost jax.distributed.initialize.
        self._platform: str = ""

    @property
    def PLATFORM(self) -> str:
        if not self._platform:
            self._platform = jax.default_backend()
        return self._platform

    @property
    def USE_MIXED_PRECISION(self) -> bool:
        return precision.mixed_precision_enabled()

    @USE_MIXED_PRECISION.setter
    def USE_MIXED_PRECISION(self, enabled: bool):
        precision.set_mixed_precision(enabled)

    @property
    def USE_CHECKPOINTING(self) -> bool:
        return precision.checkpointing_enabled()

    @USE_CHECKPOINTING.setter
    def USE_CHECKPOINTING(self, enabled: bool):
        precision.set_checkpointing(enabled)

    def set_device(self, device: str):
        self._platform = device

    def set_precision(self, use_mixed_precision: bool):
        self.USE_MIXED_PRECISION = use_mixed_precision

    def get_info(self) -> Dict[str, Any]:
        return {
            "device": self.PLATFORM,
            "mixed_precision": self.USE_MIXED_PRECISION,
            "checkpointing": self.USE_CHECKPOINTING,
            "chunk_size": self.DEFAULT_CHUNK_SIZE,
            "max_sequence_length": self.MAX_SEQUENCE_LENGTH,
            "jax_version": jax.__version__,
            "device_count": jax.device_count(),
        }


config = Config()


def create_speech_hmm(
    num_states: int,
    feature_dim: int,
    model_type: str = "mixture_gaussian",
    *,
    rngs: Optional[nnx.Rngs] = None,
    **kwargs,
):
    """Speech-optimized model factory (``__init__.py:229-274``).

    ``model_type``: ``mixture_gaussian`` | ``hsmm`` | ``streaming``.
    The models are flax ``nnx`` modules.
    """
    from flax import nnx

    from .models import HSMMLayer, MixtureGaussianHMMLayer
    from .streaming import StreamingHMMProcessor

    rngs = rngs or nnx.Rngs(0)
    if model_type == "mixture_gaussian":
        kwargs.setdefault("num_components", 3)
        kwargs.setdefault("covariance_type", "diag")
        return MixtureGaussianHMMLayer(
            num_states=num_states, feature_dim=feature_dim, rngs=rngs,
            **kwargs,
        )
    if model_type == "hsmm":
        kwargs.setdefault("duration_distribution", "gamma")
        kwargs.setdefault("max_duration", 50)
        return HSMMLayer(
            num_states=num_states, feature_dim=feature_dim, rngs=rngs,
            **kwargs,
        )
    if model_type == "streaming":
        kwargs.setdefault("chunk_size", 160)
        kwargs.setdefault("use_beam_search", True)
        return StreamingHMMProcessor(
            num_states=num_states, feature_dim=feature_dim, rngs=rngs,
            **kwargs,
        )
    raise ValueError(
        f"Unknown model_type: {model_type}. "
        f"Choose from: 'mixture_gaussian', 'hsmm', 'streaming'"
    )


# Default Korean phoneme inventory (``__init__.py:287-292``).
KOREAN_PHONEMES = [
    "sil", "a", "e", "i", "o", "u", "eo", "eu", "ui",            # vowels
    "k", "n", "t", "r", "m", "p", "s", "ng", "j", "ch",
    "kh", "th", "ph", "h", "kk", "tt", "pp", "ss", "jj",          # consonants
]


def create_korean_tts_hmm(phoneme_list: Optional[list] = None, **kwargs):
    """Korean-TTS-sized model (``__init__.py:276-300``)."""
    if phoneme_list is None:
        phoneme_list = KOREAN_PHONEMES
    kwargs.setdefault("feature_dim", 80)
    kwargs.setdefault("model_type", "mixture_gaussian")
    return create_speech_hmm(num_states=len(phoneme_list), **kwargs)


def get_speech_transitions(num_states: int, speech_type: str = "normal"):
    """Pre-configured speech transition matrices (``__init__.py:303-339``):
    ``normal`` | ``fast`` | ``slow`` | ``emotional``."""
    from .utils import (
        create_left_to_right_matrix,
        create_skip_state_matrix,
        create_transition_matrix,
    )

    if speech_type == "normal":
        return create_left_to_right_matrix(num_states, self_loop_prob=0.7)
    if speech_type == "fast":
        return create_skip_state_matrix(
            num_states, self_loop_prob=0.5, forward_prob=0.4, skip_prob=0.1
        )
    if speech_type == "slow":
        return create_left_to_right_matrix(num_states, self_loop_prob=0.85)
    if speech_type == "emotional":
        return create_transition_matrix(
            num_states, "left_to_right_skip",
            self_loop_prob=0.6, forward_prob=0.3, skip_prob=0.1,
        )
    raise ValueError(f"Unknown speech_type: {speech_type}")


class ModelFactory:
    """Common task-tuned configurations (``__init__.py:342-376``); the
    models are flax ``nnx`` modules."""

    @staticmethod
    def create_asr_model(vocabulary_size: int, acoustic_dim: int = 80,
                         *, rngs: Optional[nnx.Rngs] = None):
        from flax import nnx

        from .models import MixtureGaussianHMMLayer

        return MixtureGaussianHMMLayer(
            num_states=vocabulary_size,
            feature_dim=acoustic_dim,
            num_components=4,
            covariance_type="diag",
            learnable_transitions=True,
            rngs=rngs or nnx.Rngs(0),
        )

    @staticmethod
    def create_tts_model(num_phonemes: int, mel_dim: int = 80,
                         *, rngs: Optional[nnx.Rngs] = None):
        from flax import nnx

        from .models import HSMMLayer

        return HSMMLayer(
            num_states=num_phonemes,
            feature_dim=mel_dim,
            duration_distribution="gamma",
            max_duration=30,
            learnable_duration_params=True,
            rngs=rngs or nnx.Rngs(0),
        )

    @staticmethod
    def create_realtime_model(num_states: int, feature_dim: int = 80,
                              *, rngs: Optional[nnx.Rngs] = None):
        from flax import nnx

        from .streaming import StreamingHMMProcessor

        return StreamingHMMProcessor(
            num_states=num_states,
            feature_dim=feature_dim,
            chunk_size=160,
            use_beam_search=False,
            lookahead_frames=3,
            rngs=rngs or nnx.Rngs(0),
        )


def get_device_info() -> Dict[str, Any]:
    """JAX device/capability information (``__init__.py:379-396``)."""
    devices = jax.devices()
    info: Dict[str, Any] = {
        "jax_version": jax.__version__,
        "platform": jax.default_backend(),
        "device_count": len(devices),
        "devices": [str(d) for d in devices],
        "gpu_available": any(d.platform == "gpu" for d in devices),
    }
    try:
        info["local_device_count"] = jax.local_device_count()
    except RuntimeError:  # pragma: no cover
        info["local_device_count"] = len(devices)
    return info


def run_quick_test() -> None:
    """End-to-end smoke test over the main model families
    (``__init__.py:398-429``). Raises on the first failure, so the
    ``pytorch-hmm-tpu-test`` console script exits non-zero then and 0 on
    success. Needs flax."""
    from flax import nnx

    from .hmm import HMM
    from .models import HSMMLayer, MixtureGaussianHMMLayer
    from .streaming import StreamingHMMProcessor
    from .utils import create_left_to_right_matrix

    print("🧪 Running pytorch_hmm_tpu quick test...")
    hmm = HMM(create_left_to_right_matrix(5))
    obs = jax.random.uniform(jax.random.PRNGKey(0), (20, 5))
    hmm.viterbi_decode(obs)
    print("✅ Basic HMM: OK")

    model = MixtureGaussianHMMLayer(5, 40, 2, rngs=nnx.Rngs(0))
    data = jax.random.normal(jax.random.PRNGKey(1), (2, 20, 40))
    model(data)
    print("✅ Mixture Gaussian HMM: OK")

    hsmm = HSMMLayer(3, 40, rngs=nnx.Rngs(0))
    hsmm.generate_sequence(30)
    print("✅ HSMM: OK")

    stream = StreamingHMMProcessor(
        5, 40, chunk_size=10, lookahead_frames=0, rngs=nnx.Rngs(0)
    )
    chunk = jax.random.normal(jax.random.PRNGKey(2), (10, 40))
    stream.process_chunk(chunk)
    print("✅ Streaming HMM: OK")
    print("🎉 All tests passed!")


def check_optional_dependencies() -> Dict[str, Optional[str]]:
    """Probe optional integrations (``__init__.py:432-454``)."""
    deps: Dict[str, Optional[str]] = {}
    for name in ("librosa", "matplotlib", "soundfile"):
        try:
            mod = __import__(name)
            deps[name] = getattr(mod, "__version__", "unknown")
        except ImportError:
            deps[name] = None
    return deps


def auto_configure() -> Dict[str, Any]:
    """Size config by the detected platform (``__init__.py:457-477``) —
    explicit call, never run at import time."""
    info = get_device_info()
    if info["gpu_available"]:
        config.set_device("gpu")
        config.MAX_SEQUENCE_LENGTH = 100_000
        config.DEFAULT_CHUNK_SIZE = 2000
        print("🚀 Configured for GPU")
    else:
        config.set_device("cpu")
        config.MAX_SEQUENCE_LENGTH = 20_000
        config.DEFAULT_CHUNK_SIZE = 500
        config.set_precision(False)
        print("💻 Configured for CPU processing")
    return config.get_info()
