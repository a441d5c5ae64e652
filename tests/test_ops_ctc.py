"""CTC lattice scans vs independent oracles: torch's ``ctc_loss`` for the
loss and its gradient (ragged batches and wide lattices up to S=2001), a
brute-force search for forced alignment, and the alignment's own
consistency (it collapses to the target and scores what it reports)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oracle import ctc_viterbi_brute
from pytorch_hmm_tpu.alignment.ctc import (
    ctc_alignment_path,
    ctc_backward_algorithm,
    ctc_forward_algorithm,
    ctc_loss,
    ctc_viterbi_alignment,
)

torch = pytest.importorskip("torch")


def _problem(B, T, C, U, seed, ragged=False):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(T, B, C)).astype(np.float32)
    # Targets without immediate repeats need only U frames.
    targets = np.empty((B, U), np.int64)
    for b in range(B):
        prev = 0
        for u in range(U):
            c = int(rng.integers(1, C - 1))
            c += c >= prev and prev > 0
            targets[b, u] = prev = c
    if ragged:
        in_lens = rng.integers(max(U + 1, T // 2), T + 1, size=B)
        in_lens[0] = T
        tgt_lens = rng.integers(1, U + 1, size=B)
    else:
        in_lens = np.full((B,), T)
        tgt_lens = np.full((B,), U)
    return logits, targets, in_lens.astype(np.int64), tgt_lens.astype(np.int64)


def _torch_loss_and_grad(logits, targets, in_lens, tgt_lens):
    x = torch.tensor(logits, dtype=torch.float64, requires_grad=True)
    lp = torch.log_softmax(x, dim=-1)
    loss = torch.nn.functional.ctc_loss(
        lp, torch.tensor(targets), torch.tensor(in_lens),
        torch.tensor(tgt_lens), blank=0, reduction="none",
    )
    loss.sum().backward()
    return loss.detach().numpy(), x.grad.numpy()


def _ours_loss_and_grad(logits, targets, in_lens, tgt_lens):
    args = (jnp.asarray(targets, jnp.int32), jnp.asarray(in_lens, jnp.int32),
            jnp.asarray(tgt_lens, jnp.int32))

    def f(x):
        return ctc_loss(jax.nn.log_softmax(x, axis=-1), *args,
                        reduction="none")

    nll, vjp = jax.vjp(f, jnp.asarray(logits))
    (g,) = vjp(jnp.ones_like(nll))
    return np.asarray(nll), np.asarray(g)


@pytest.mark.parametrize("B,T,C,U,seed,ragged", [
    (4, 200, 20, 30, 0, False),
    (3, 300, 12, 10, 1, True),
    (2, 64, 8, 5, 2, True),       # short T, tiny lattice
    (1, 128, 30, 63, 3, False),   # lattice S=127
    (3, 300, 30, 140, 4, True),   # wide lattice S=281, ragged
])
def test_ctc_loss_matches_torch(B, T, C, U, seed, ragged):
    logits, targets, in_lens, tgt_lens = _problem(B, T, C, U, seed, ragged)
    nll_t, g_t = _torch_loss_and_grad(logits, targets, in_lens, tgt_lens)
    nll, g = _ours_loss_and_grad(logits, targets, in_lens, tgt_lens)
    np.testing.assert_allclose(nll, nll_t, rtol=1e-4, atol=1e-3)
    valid = np.arange(T)[:, None] < in_lens[None, :]          # (T, B)
    # float32 lattice (posteriors from alpha+beta-ll at |ll| ~ 1e2-1e3)
    # against torch in float64.
    np.testing.assert_allclose(g[valid], g_t[valid], atol=1e-3)
    assert not np.asarray(g[~valid]).any()


def test_ctc_wide_lattice_2001_matches_torch():
    """The widest lattice of the benchmark regime: U=1000 labels, S=2001."""
    logits, targets, in_lens, tgt_lens = _problem(1, 1100, 40, 1000, 5)
    nll_t, _ = _torch_loss_and_grad(logits, targets, in_lens, tgt_lens)
    nll, _ = _ours_loss_and_grad(logits, targets, in_lens, tgt_lens)
    np.testing.assert_allclose(nll, nll_t, rtol=1e-4)


def test_ctc_loss_grad_matches_autodiff_scan():
    """The closed-form VJP matches differentiating through the scan."""
    logits, targets, in_lens, tgt_lens = _problem(3, 120, 10, 8, 7, True)
    log_probs = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
    args = (jnp.asarray(targets, jnp.int32), jnp.asarray(in_lens, jnp.int32),
            jnp.asarray(tgt_lens, jnp.int32))
    g_cf = jax.grad(lambda lp: ctc_loss(lp, *args, reduction="sum"))(
        log_probs)
    g_ad = jax.grad(
        lambda lp: -jnp.sum(ctc_forward_algorithm(lp, *args)[1]))(log_probs)
    np.testing.assert_allclose(np.asarray(g_cf), np.asarray(g_ad), atol=1e-4)


def test_ctc_forward_backward_consistent():
    """Every frame's lattice mass alpha+beta sums to the same likelihood."""
    logits, targets, in_lens, tgt_lens = _problem(2, 80, 9, 12, 8, True)
    args = (jax.nn.log_softmax(jnp.asarray(logits), -1),
            jnp.asarray(targets, jnp.int32), jnp.asarray(in_lens, jnp.int32),
            jnp.asarray(tgt_lens, jnp.int32))
    alpha, ll = ctc_forward_algorithm(*args)
    beta = ctc_backward_algorithm(*args)
    tot = jax.scipy.special.logsumexp(alpha + beta, axis=-1)   # (B, T)
    for b in range(2):
        L = int(in_lens[b])
        np.testing.assert_allclose(tot[b, :L], ll[b], rtol=1e-5)


@pytest.mark.parametrize("T,C,target,seed", [
    (5, 3, [1, 2], 0),
    (6, 3, [1, 1], 1),      # a repeat needs a blank between
    (6, 4, [3, 1, 2], 2),
    (4, 3, [2], 3),
])
def test_ctc_viterbi_matches_brute_force(T, C, target, seed):
    rng = np.random.default_rng(seed)
    lp = jax.nn.log_softmax(
        jnp.asarray(rng.normal(size=(T, 1, C)) * 2, jnp.float32), -1)
    labels, score = ctc_viterbi_brute(np.asarray(lp[:, 0], np.float64),
                                      target)
    ali, sc = ctc_viterbi_alignment(
        lp, jnp.asarray([target], jnp.int32), jnp.asarray([T], jnp.int32),
        jnp.asarray([len(target)], jnp.int32))
    np.testing.assert_array_equal(np.asarray(ali[0]), labels)
    np.testing.assert_allclose(float(sc[0]), score, rtol=1e-5)


def _collapse(labels):
    return [c for k, c in enumerate(labels)
            if c != 0 and (k == 0 or labels[k - 1] != c)]


@pytest.mark.parametrize("B,T,C,U,seed,ragged", [
    (4, 96, 12, 10, 0, False),
    (3, 120, 10, 8, 1, True),
    (2, 64, 30, 20, 2, True),
    (2, 384, 40, 180, 3, True),   # wide lattice S=361
])
def test_ctc_viterbi_alignment_is_consistent(B, T, C, U, seed, ragged):
    """The alignment collapses to the target, its frame scores sum to the
    reported score, padded frames repeat the last label, and no path
    beats the total lattice mass."""
    logits, targets, in_lens, tgt_lens = _problem(B, T, C, U, seed, ragged)
    lp = jax.nn.log_softmax(jnp.asarray(logits), -1)
    args = (jnp.asarray(targets, jnp.int32), jnp.asarray(in_lens, jnp.int32),
            jnp.asarray(tgt_lens, jnp.int32))
    ali, score = ctc_viterbi_alignment(lp, *args)
    _, ll = ctc_forward_algorithm(lp, *args)
    ali, lp_np = np.asarray(ali), np.asarray(lp, np.float64)
    for b in range(B):
        L, n = int(in_lens[b]), int(tgt_lens[b])
        assert _collapse(list(ali[b, :L])) == list(targets[b, :n])
        own = lp_np[np.arange(L), b, ali[b, :L]].sum()
        np.testing.assert_allclose(float(score[b]), own, rtol=1e-5)
        assert (ali[b, L:] == ali[b, L - 1]).all()
        assert float(score[b]) <= float(ll[b]) + 1e-3


def test_ctc_alignment_path_collapses_to_target():
    logits, targets, in_lens, tgt_lens = _problem(2, 60, 8, 6, 9, True)
    paths = ctc_alignment_path(
        jax.nn.log_softmax(jnp.asarray(logits), -1),
        jnp.asarray(targets, jnp.int32), jnp.asarray(in_lens, jnp.int32),
        jnp.asarray(tgt_lens, jnp.int32))
    for b, p in enumerate(paths):
        assert len(p) == int(in_lens[b])


def test_ctc_beam_decode_large_vocab():
    """C=1024 vocabulary beam decode must match the host prefix-beam
    oracle (the reference's nn.CTCLoss has no vocab cap; neither do
    we)."""
    from pytorch_hmm_tpu.alignment import beam_search_decode_batch
    from pytorch_hmm_tpu.alignment.ctc import _prefix_beam_search

    T, B, C = 20, 2, 1024
    rng = np.random.default_rng(3)
    lp = jax.nn.log_softmax(
        jnp.asarray(rng.normal(size=(T, B, C)) * 2.0, jnp.float32), -1
    )
    in_lens = jnp.asarray([T, T - 5], jnp.int32)
    tokens, out_lens = beam_search_decode_batch(
        lp, in_lens, beam_width=4, blank_id=0
    )
    lp_np = np.asarray(lp)
    for b in range(B):
        host = _prefix_beam_search(lp_np[: int(in_lens[b]), b], 4,
                                   blank_id=0)
        got = list(np.asarray(tokens[b, : out_lens[b]]))
        assert got == list(host), (b, got, host)
