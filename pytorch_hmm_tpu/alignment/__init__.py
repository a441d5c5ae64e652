"""Alignment algorithms: DTW and CTC (reference ``alignment/__init__.py``).

Both are wavefront/lattice ``lax.scan`` DPs — no per-cell Python loops —
plus extras (soft-DTW with exact expected alignments, lattice
Viterbi forced alignment, a real CTC prefix beam search).
"""

from .ctc import (
    CTCAligner,
    CTCSegmentationAligner,
    collapse_repeated_tokens,
    ctc_alignment_path,
    ctc_backward_algorithm,
    ctc_decode_sequence,
    ctc_forward_algorithm,
    ctc_loss,
    ctc_viterbi_alignment,
    expand_targets_with_blank,
    remove_ctc_blanks,
)
from .ctc_decode import beam_search_decode_batch, greedy_decode_batch
from .dtw import (
    ConstrainedDTWAligner,
    DTWAligner,
    compute_distance_matrix,
    compute_dtw_path,
    dtw_alignment,
    dtw_distance,
    extract_phoneme_durations,
    phoneme_audio_alignment,
    soft_dtw,
    soft_dtw_alignment,
)

__all__ = [
    # DTW
    "DTWAligner",
    "ConstrainedDTWAligner",
    "compute_distance_matrix",
    "compute_dtw_path",
    "dtw_alignment",
    "dtw_distance",
    "soft_dtw",
    "soft_dtw_alignment",
    "phoneme_audio_alignment",
    "extract_phoneme_durations",
    # CTC
    "CTCAligner",
    "CTCSegmentationAligner",
    "ctc_alignment_path",
    "ctc_viterbi_alignment",
    "ctc_forward_algorithm",
    "ctc_backward_algorithm",
    "ctc_loss",
    "expand_targets_with_blank",
    "remove_ctc_blanks",
    "collapse_repeated_tokens",
    "ctc_decode_sequence",
    "greedy_decode_batch",
    "beam_search_decode_batch",
]
