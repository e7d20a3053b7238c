"""HMM dynamic-programming kernels: forward, backward, Viterbi.

Replaces the reference's per-timestep Python loops
(``StatisticalModel/LHMM.py:335-366`` forward/backward,
``LHMM.py:546-609`` Viterbi) with ``lax.scan`` over time — batched over
utterances via ``vmap`` with padding masks (SURVEY.md §7 step 4).

Two transition representations:

* **dense** ``log_A[N, N]`` — general API parity with ``LHMM.viterbi``'s
  arbitrary transmat argument;
* **banded** ``band[N, W]`` with ``band[j, k] = log_A[j, j+k]`` — the
  embedded sentence HMM (``AcousticModel.py:957-1014``) is strictly
  left-to-right with bandwidth ``W = state_num - 1``, so each DP step is
  O(N·W) shifted adds instead of an O(N²) log-matvec (SURVEY.md §7 hard
  part (d)).

Masking discipline: padded timesteps are identity steps (the carry
passes through unchanged), so the final carry equals the value at each
utterance's true last frame and one batched scan serves ragged lengths.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from poccala_tpu.utils.logmath import NEG_INF


def _lse(x, axis):
    return jax.nn.logsumexp(x, axis=axis)


def _clamp(x):
    """Keep 'impossible' canonical: sums of NEG_INF sentinels (e.g. into
    an absorbing exit state) would otherwise drift below NEG_INF."""
    return jnp.maximum(x, NEG_INF)


# ======================================================================
# Dense kernels
# ======================================================================

@jax.jit
def forward_log(log_A, log_pi, log_b, t_mask):
    """Forward algorithm in log space (``LHMM.py:335-351``).

    The recursion carries a **renormalized** alpha (per-step max
    subtracted) with the running shift accumulated by Kahan-compensated
    summation.  The naive form loses ``eps_f32 · |alpha|`` per step:
    with floor-variance GMMs the per-frame log-densities reach 1e2–1e4,
    ``|alpha|`` grows to ~1e5 over a 512-frame utterance, and the
    accumulated f32 error reaches whole nats (the round-3 flagship WER
    artifact's 1.1e-2 "parity gap" vs the f64 reference was exactly
    this; see ``tests/test_parity_drift.py``).  Renormalization keeps
    the lse inputs O(per-frame score) and the shift exact, measured
    8–20× closer to the f64 oracle at those magnitudes.

    :param log_A: ``[N, N]`` log transition matrix
    :param log_pi: ``[N]`` log initial distribution
    :param log_b: ``[T, N]`` observation log-probs
    :param t_mask: ``[T]`` bool frame-validity mask
    :returns: (``log_alpha [T, N]``, ``loglik`` scalar) — loglik is
        ``logsumexp(alpha[T_true - 1])`` (``LHMM.py:412-422``)
    """
    alpha0 = log_pi + log_b[0]
    m0 = jnp.max(alpha0)
    shift0 = jnp.where(m0 > NEG_INF / 2, m0, 0.0)
    a0 = jnp.where(alpha0 > NEG_INF / 2, alpha0 - shift0, NEG_INF)

    def step(carry, inp):
        alpha, shift, comp = carry
        b_t, m_t = inp
        nxt = _clamp(_lse(alpha[:, None] + log_A, axis=0) + b_t)
        m = jnp.max(nxt)
        ms = jnp.where(m > NEG_INF / 2, m, 0.0)
        nxt = jnp.where(nxt > NEG_INF / 2, nxt - ms, NEG_INF)
        # Kahan-compensated shift accumulation
        y = ms - comp
        t_new = shift + y
        comp_new = (t_new - shift) - y
        alpha = jnp.where(m_t, nxt, alpha)
        shift = jnp.where(m_t, t_new, shift)
        comp = jnp.where(m_t, comp_new, comp)
        return (alpha, shift, comp), (alpha, shift)

    (last, shift_l, _), (alphas, shifts) = jax.lax.scan(
        step, (a0, shift0, jnp.zeros(())), (log_b[1:], t_mask[1:]))
    # reconstruct absolute alphas for callers (posteriors etc.)
    log_alpha = jnp.concatenate([
        alpha0[None],
        jnp.where(alphas > NEG_INF / 2, alphas + shifts[:, None], NEG_INF),
    ], axis=0)
    return log_alpha, shift_l + _lse(last, axis=-1)


@jax.jit
def backward_log(log_A, log_b, t_mask):
    """Backward algorithm in log space (``LHMM.py:353-366``);
    ``beta[T_true-1] = 0``.

    Scanned in reverse over padded frames: while ``t+1`` is padding the
    carry stays 0, so each utterance's recursion starts exactly at its
    own final frame.
    """
    t_pad, n = log_b.shape
    beta_last = jnp.zeros((n,))

    def step(beta, inp):
        b_next, m_next = inp  # data at t+1 and its validity
        nxt = _clamp(_lse(log_A + (b_next + beta)[None, :], axis=1))
        beta = jnp.where(m_next, nxt, beta_last)
        return beta, beta

    _, betas = jax.lax.scan(
        step, beta_last, (log_b[1:], t_mask[1:]), reverse=True
    )
    return jnp.concatenate([betas, beta_last[None]], axis=0)


@jax.jit
def viterbi_log(log_A, log_pi, log_b, t_mask):
    """Max-product DP with backtrace (``LHMM.py:546-609``).

    Padded steps carry delta unchanged with identity backpointers, so the
    backtrace threads through padding untouched.

    :returns: (``score`` best final log prob, ``path [T] int32``,
        ``final_delta [N]``)
    """
    t_pad, n = log_b.shape
    delta0 = log_pi + log_b[0]
    idx = jnp.arange(n, dtype=jnp.int32)

    def step(delta, inp):
        b_t, m_t = inp
        scores = delta[:, None] + log_A  # [from, to]
        bp = jnp.argmax(scores, axis=0).astype(jnp.int32)
        nxt = _clamp(jnp.max(scores, axis=0) + b_t)
        delta = jnp.where(m_t, nxt, delta)
        bp = jnp.where(m_t, bp, idx)
        return delta, bp

    delta_last, bps = jax.lax.scan(step, delta0, (log_b[1:], t_mask[1:]))
    best_last = jnp.argmax(delta_last).astype(jnp.int32)
    score = delta_last[best_last]

    def back(state, bp):
        # bp[i][j] = predecessor (state at time i) of state j at time i+1,
        # so the emitted value for position i is the predecessor.
        prev = bp[state]
        return prev, prev

    _, path_rev = jax.lax.scan(back, best_last, bps, reverse=True)
    path = jnp.concatenate([path_rev, best_last[None]], axis=0)
    return score, path, delta_last


@jax.jit
def forward_log_assoc(log_A, log_pi, log_b):
    """Forward algorithm via ``associative_scan`` — O(log T) depth.

    The forward recursion is a product of (logsumexp, +)-semiring
    operators ``M_t[i, j] = log_A[i, j] + log_b[t, j]``; prefix products
    give every ``log_alpha`` row at once.  O(T·N³) work instead of
    O(T·N²), but parallel over time — the right trade for very long
    audio on wide hardware (SURVEY.md §5 "long-context": time-parallel
    scan replaces sequence-axis sharding in this model family).

    :returns: (``log_alpha [T, N]``, ``loglik``), matching
        :func:`forward_log` on unmasked inputs.
    """
    t, n = log_b.shape

    def combine(m1, m2):
        # (m1 ∘ m2)[i, j] = LSE_k(m1[i, k] + m2[k, j]); batched [.., N, N]
        return _clamp(
            jax.nn.logsumexp(m1[..., :, :, None] + m2[..., None, :, :],
                             axis=-2)
        )

    ops = log_A[None, :, :] + log_b[1:, None, :]       # [T-1, N, N]
    prefix = jax.lax.associative_scan(combine, ops, axis=0)
    alpha0 = log_pi + log_b[0]
    tail = _clamp(
        jax.nn.logsumexp(alpha0[None, :, None] + prefix, axis=1)
    )  # [T-1, N]
    log_alpha = jnp.concatenate([alpha0[None], tail], axis=0)
    return log_alpha, _lse(log_alpha[-1], axis=-1)


# ======================================================================
# Banded (left-to-right) kernels
# ======================================================================

def dense_to_band(log_A, w: int):
    """Extract ``band[j, k] = log_A[j, j+k]`` for ``k in [0, w)``;
    out-of-range entries are NEG_INF."""
    n = log_A.shape[0]
    j = jnp.arange(n)[:, None]
    k = jnp.arange(w)[None, :]
    col = j + k
    valid = col < n
    return jnp.where(valid, log_A[j, jnp.clip(col, 0, n - 1)], NEG_INF)


def band_to_dense(band):
    """Inverse of :func:`dense_to_band` (NEG_INF off-band)."""
    n, w = band.shape
    out = jnp.full((n, n), NEG_INF)
    j = jnp.arange(n)[:, None].repeat(w, 1)
    col = j + jnp.arange(w)[None, :]
    valid = col < n
    return out.at[j, jnp.clip(col, 0, n - 1)].max(
        jnp.where(valid, band, NEG_INF)
    )


def _shift_down(x, k, fill):
    """out[j] = x[j-k] (prepend fill)."""
    if k == 0:
        return x
    return jnp.concatenate([jnp.full((k,), fill, x.dtype), x[:-k]])


def _shift_up(x, k, fill):
    """out[j] = x[j+k] (append fill)."""
    if k == 0:
        return x
    return jnp.concatenate([x[k:], jnp.full((k,), fill, x.dtype)])


@functools.partial(jax.jit, static_argnames=("w",))
def forward_log_banded(band, log_pi, log_b, t_mask, w: int):
    """Banded forward: ``α'[j] = b[j] + LSE_k(α[j-k] + band[j-k, k])``.

    O(N·W) per step; W is static and small (``state_num - 1``), so the
    k-loop unrolls at trace time into W shifted elementwise adds.
    """
    alpha0 = log_pi + log_b[0]

    def step(alpha, inp):
        b_t, m_t = inp
        terms = jnp.stack(
            [_shift_down(alpha + band[:, k], k, NEG_INF) for k in range(w)]
        )
        nxt = _clamp(_lse(terms, axis=0) + b_t)
        return jnp.where(m_t, nxt, alpha), None

    def step_collect(alpha, inp):
        new_alpha, _ = step(alpha, inp)
        return new_alpha, new_alpha

    last, alphas = jax.lax.scan(step_collect, alpha0, (log_b[1:], t_mask[1:]))
    log_alpha = jnp.concatenate([alpha0[None], alphas], axis=0)
    return log_alpha, _lse(last, axis=-1)


@functools.partial(jax.jit, static_argnames=("w",))
def backward_log_banded(band, log_b, t_mask, w: int):
    """Banded backward: ``β[j] = LSE_k(band[j, k] + b[j+k] + β[j+k])``."""
    t_pad, n = log_b.shape
    beta_last = jnp.zeros((n,))

    def step(beta, inp):
        b_next, m_next = inp
        s = b_next + beta
        terms = jnp.stack(
            [band[:, k] + _shift_up(s, k, NEG_INF) for k in range(w)]
        )
        nxt = _clamp(_lse(terms, axis=0))
        return jnp.where(m_next, nxt, beta_last), nxt

    def step_collect(beta, inp):
        new_beta, _ = step(beta, inp)
        return new_beta, new_beta

    _, betas = jax.lax.scan(
        step_collect, beta_last, (log_b[1:], t_mask[1:]), reverse=True
    )
    return jnp.concatenate([betas, beta_last[None]], axis=0)


@functools.partial(jax.jit, static_argnames=("w", "end_states"))
def viterbi_log_banded(band, log_pi, log_b, t_mask, w: int,
                       end_states: int = 0):
    """Banded Viterbi with offset backpointers.

    :param end_states: if > 0, restrict the final argmax to the last
        ``end_states`` states (the reference's ``end_state_back`` picks
        among the last 4, ``LHMM.py:586-589``); 0 = unrestricted.
    :returns: (score, path ``[T] int32``, final_delta ``[N]``)
    """
    t_pad, n = log_b.shape
    delta0 = log_pi + log_b[0]
    zero_off = jnp.zeros((n,), jnp.int32)

    def step(delta, inp):
        b_t, m_t = inp
        terms = jnp.stack(
            [_shift_down(delta + band[:, k], k, NEG_INF) for k in range(w)]
        )  # [W, N]: terms[k, j] = delta[j-k] + band[j-k, k]
        best_k = jnp.argmax(terms, axis=0).astype(jnp.int32)  # offset
        nxt = _clamp(jnp.max(terms, axis=0) + b_t)
        delta = jnp.where(m_t, nxt, delta)
        off = jnp.where(m_t, best_k, zero_off)
        return delta, off

    delta_last, offs = jax.lax.scan(step, delta0, (log_b[1:], t_mask[1:]))

    if end_states > 0:
        tail = delta_last[n - end_states:]
        best_last = (n - end_states + jnp.argmax(tail)).astype(jnp.int32)
    else:
        best_last = jnp.argmax(delta_last).astype(jnp.int32)
    score = delta_last[best_last]

    def back(state, off):
        prev = state - off[state]
        return prev, prev

    _, path_rev = jax.lax.scan(back, best_last, offs, reverse=True)
    path = jnp.concatenate([path_rev, best_last[None]], axis=0)
    return score, path, delta_last


# ======================================================================
# Batched wrappers
# ======================================================================

def forward_log_banded_batch(bands, log_pis, log_bs, t_masks, w: int):
    """vmap over utterances: bands ``[B,N,W]``, log_bs ``[B,T,N]``…"""
    fn = functools.partial(forward_log_banded, w=w)
    return jax.vmap(fn)(bands, log_pis, log_bs, t_masks)


def backward_log_banded_batch(bands, log_bs, t_masks, w: int):
    fn = functools.partial(backward_log_banded, w=w)
    return jax.vmap(fn)(bands, log_bs, t_masks)


def viterbi_log_banded_batch(bands, log_pis, log_bs, t_masks, w: int,
                             end_states: int = 0):
    fn = functools.partial(viterbi_log_banded, w=w, end_states=end_states)
    return jax.vmap(fn)(bands, log_pis, log_bs, t_masks)
