"""Log-domain math primitives.

Batched replacement for the reference's scalar helpers in
``StatisticalModel/util.py:20-92``: ``log_sum_exp`` (scalar/rowwise Python
loops), ``matrix_log_sum_exp`` (list folds) and ``gaussian_function``
(per-vector diagonal Gaussian).  Everything here is batched, jittable and
fusible by XLA; the Python-list folds become plain array reductions.

Numerics note (SURVEY.md §7 "hard parts" (b)): the reference's log-space
Gaussian normalizer is ``-D/2*log(2π) - 0.5*Σ diag(cov)`` (``util.py:29``)
— the textbook formula has ``0.5*Σ log diag``.  Both are implemented;
``normalizer='reference'`` reproduces the reference's actual numerics for
parity testing, ``'textbook'`` (default) is the correct density.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

LOG_2PI = math.log(2.0 * math.pi)
# A large-but-finite stand-in for log(0).  Using -inf directly inside
# scans is fine for forward/Viterbi, but (-inf) - (-inf) = nan poisons
# gradients and accumulator ratios; masked arithmetic uses this instead.
NEG_INF = -1e30


def logsumexp(x: jax.Array, axis=None, keepdims: bool = False) -> jax.Array:
    """Numerically-stable log-sum-exp (reference ``util.py:54-77``).

    Matches the reference's edge case: if the max along ``axis`` is ±inf
    the result is that max (``util.py:63-65``) — ``jax.nn.logsumexp``
    already yields -inf for all--inf rows; we additionally guard the nan
    that arises from (inf - inf) when infinities are mixed.
    """
    out = jax.nn.logsumexp(x, axis=axis, keepdims=keepdims)
    # all--inf rows produce -inf (correct); nan can only appear if inputs
    # contained nan or +inf - both are upstream bugs we surface unchanged.
    return out


def log_matvec(log_A: jax.Array, log_x: jax.Array) -> jax.Array:
    """Log-domain matrix-vector product: ``out[j] = LSE_i(log_x[i] + log_A[i, j])``.

    Replaces ``util.matrix_dot`` (``util.py:39-51``) which loops in Python.
    Shapes: ``log_A[N, M]``, ``log_x[N]`` -> ``out[M]``.
    """
    return logsumexp(log_x[:, None] + log_A, axis=0)


def diag_gaussian_logpdf(
    x: jax.Array,
    mean: jax.Array,
    log_var: jax.Array,
    normalizer: str = "textbook",
) -> jax.Array:
    """Diagonal-covariance Gaussian log-density, batched.

    Reference semantics: ``util.gaussian_function(..., log=True)``
    (``util.py:20-31``), which computes
    ``-D/2*log(2π) - 0.5*Σ diag - 0.5*(x-μ)ᵀ diag⁻¹ (x-μ)``.

    :param x:       ``[..., D]`` data
    :param mean:    ``[..., D]`` means (broadcast against x)
    :param log_var: ``[..., D]`` log of the diagonal variances
    :param normalizer: 'textbook' -> ``-0.5*Σ log σ²`` (correct density);
        'reference' -> ``-0.5*Σ σ²`` (reproduces ``util.py:29``).
    :returns: ``[...]`` log densities
    """
    d = x.shape[-1]
    diff = x - mean
    quad = -0.5 * jnp.sum(diff * diff * jnp.exp(-log_var), axis=-1)
    if normalizer == "textbook":
        norm = -0.5 * d * LOG_2PI - 0.5 * jnp.sum(log_var, axis=-1)
    elif normalizer == "reference":
        norm = -0.5 * d * LOG_2PI - 0.5 * jnp.sum(jnp.exp(log_var), axis=-1)
    else:
        raise ValueError(f"unknown normalizer: {normalizer!r}")
    return norm + quad


def masked_log(x: jax.Array) -> jax.Array:
    """``log(x)`` with log(0) -> NEG_INF instead of -inf/nan warnings
    (the reference silences these via ``np.seterr(divide='ignore')``,
    ``LHMM.py:570``)."""
    return jnp.where(x > 0, jnp.log(jnp.maximum(x, 1e-300)), NEG_INF)


def safe_exp_sub(log_num: jax.Array, log_den: jax.Array) -> jax.Array:
    """``exp(log_num - log_den)`` with 0 when the denominator is empty
    (reference guards: ``LHMM.py:517-518``, ``Clustering.py:685-693``)."""
    ok = log_den > NEG_INF / 2
    return jnp.where(ok, jnp.exp(log_num - jnp.where(ok, log_den, 0.0)), 0.0)
