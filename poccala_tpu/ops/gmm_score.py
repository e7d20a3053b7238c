"""Diagonal-GMM log-likelihood scoring as matmuls.

This is the reference's single hottest loop: ``cal_observation_pro``
(``StatisticalModel/LHMM.py:163-187``) calls ``GMM.point``
(``Clustering.py:740-767``) per frame × state × mixture, each a scalar
``gaussian_function`` (``util.py:20-31``).  O(T·S·M·D) scalar Python work.

Batched-dense form (SURVEY.md §7 step 3): expand the Mahalanobis term

    Σ_d (x-μ)²/σ²  =  Σ_d x²·p  -  2·Σ_d x·(μp)  +  Σ_d μ²·p,   p = 1/σ²

so all frames × all (state, mixture) pairs reduce to two matmuls
``[T,D]@[D,SM]`` plus a constant fold — exactly the batched-dense form
BASELINE.json's north star names.  The mixture logsumexp is an
elementwise reduction that XLA fuses after the matmuls.

The per-frame component log-probs (the reference's ``record`` cache,
``Clustering.py:94-95, 759-760``) are returned on demand for the
Baum-Welch accumulators.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from poccala_tpu.utils.logmath import LOG_2PI, NEG_INF


@functools.partial(jax.jit, static_argnames=("normalizer", "score_dtype"))
def gmm_component_logpdf(
    x: jax.Array,
    means: jax.Array,
    log_var: jax.Array,
    normalizer: str = "textbook",
    score_dtype: str = "float32",
) -> jax.Array:
    """Per-component Gaussian log-densities for all frames × states.

    :param x: ``[T, D]`` frames
    :param means: ``[S, M, D]`` mixture means (senone bank layout)
    :param log_var: ``[S, M, D]`` log diagonal variances
    :param normalizer: 'textbook' (``-0.5Σ log σ²``) or 'reference'
        (``-0.5Σ σ²``, reproducing ``util.py:29``)
    :param score_dtype: 'float32' (default) — fp32 operands with
        ``precision=HIGHEST`` dots, required for correctness: a
        reduced-precision pass (bf16, or TF32 on a GPU) leaves an error
        that the ``1/σ²``-scaled cancellation amplifies into huge score
        errors on floor-variance senones.  'bfloat16' — centered bf16
        operands with fp32 accumulation (its speed on the H100 is not
        yet measured).  The centering (frames and means shifted by the
        frame mean; the Mahalanobis form is shift-invariant) is what
        keeps the ``x²``/``μ²`` operands small enough for bf16's 8-bit
        mantissa — uncentered drift is an order of magnitude larger
        (pinned in tests/test_bf16_scoring.py).
    :returns: ``[T, S, M]`` log N(x_t | μ_sm, σ²_sm)
    """
    s, m, d = means.shape
    prec = jnp.exp(-log_var)  # [S, M, D]
    if normalizer == "textbook":
        const = -0.5 * d * LOG_2PI - 0.5 * jnp.sum(log_var, axis=-1)
    elif normalizer == "reference":
        const = -0.5 * d * LOG_2PI - 0.5 * jnp.sum(jnp.exp(log_var), axis=-1)
    else:
        raise ValueError(f"unknown normalizer: {normalizer!r}")
    if score_dtype == "bfloat16":
        # shift-invariant centering: (x-μ)ᵀP(x-μ) is unchanged under
        # x←x-c, μ←μ-c for any c.  c = per-dim frame mean: every bf16
        # rounding error in the expansion scales with |x-c| (the x²
        # operand directly; the cross term as |x-c|·δ(μ'p)), so shrinking
        # the *frame* residual bounds the error even when the bank means
        # sit far from the data (untrained banks) — the μ'² term is
        # folded in fp32 and costs nothing
        c = jnp.mean(x, axis=0)  # [D]
        x = x - c[None]
        means = means - c[None, None]
        op = jnp.bfloat16
    elif score_dtype == "float32":
        op = jnp.float32
    else:
        raise ValueError(f"unknown score_dtype: {score_dtype!r}")
    a1 = prec.reshape(s * m, d)  # x² coefficients
    a2 = (means * prec).reshape(s * m, d)  # cross-term coefficients
    mu2p = jnp.sum(means * means * prec, axis=-1)  # [S, M]
    # precision=HIGHEST on the f32 path: a default-precision f32 dot may
    # run as one reduced-precision pass (TF32 on a GPU); with
    # floor-level variances (p = 1/σ² up to 1e6) the cancellation
    # between the x²p and 2xμp terms amplifies its mantissa error into
    # thousands of nats (observed: +1e8 "logliks" on degenerate
    # senones).  The bf16 option keeps single-pass semantics by
    # construction.
    dot_prec = (jax.lax.Precision.HIGHEST if score_dtype == "float32"
                else jax.lax.Precision.DEFAULT)
    quad = (
        jnp.dot((x * x).astype(op), a1.astype(op).T,
                preferred_element_type=jnp.float32, precision=dot_prec)
        - 2.0 * jnp.dot(x.astype(op), a2.astype(op).T,
                        preferred_element_type=jnp.float32,
                        precision=dot_prec)
    )  # [T, S*M]
    t = x.shape[0]
    return (
        -0.5 * (quad.reshape(t, s, m) + mu2p[None]) + const[None]
    )


@functools.partial(
    jax.jit,
    static_argnames=("normalizer", "return_components", "score_dtype"),
)
def gmm_log_scores(
    x: jax.Array,
    means: jax.Array,
    log_var: jax.Array,
    log_w: jax.Array,
    normalizer: str = "textbook",
    return_components: bool = False,
    score_dtype: str = "float32",
):
    """State-level GMM log-likelihoods for all frames.

    Equivalent to ``GMM.point(x, log=True)`` (``Clustering.py:740-767``):
    ``logsumexp_m(log α_m + log N_m(x))`` — but for the whole [T, S, M]
    lattice at once.  Padded mixtures carry ``log_w = -inf``/NEG_INF and
    drop out of the logsumexp (mixture-count raggedness → weight masking,
    SURVEY.md §7 hard part (f)).

    :param x: ``[T, D]``
    :param log_w: ``[S, M]`` log mixture weights
    :returns: ``[T, S]`` state scores; with ``return_components`` also the
        ``[T, S, M]`` weighted component log-probs (the ``record`` cache)
    """
    comp = gmm_component_logpdf(x, means, log_var, normalizer=normalizer,
                                score_dtype=score_dtype)
    weighted = comp + log_w[None]  # [T, S, M]
    scores = jax.nn.logsumexp(weighted, axis=-1)
    if return_components:
        return scores, weighted
    return scores


def gmm_log_scores_batch(x, x_mask, means, log_var, log_w,
                         normalizer: str = "textbook",
                         score_dtype: str = "float32"):
    """Batched scoring: ``x[B, T, D]`` → ``[B, T, S]``; padded frames are
    scored but the mask is passed through for downstream DP kernels."""
    fn = functools.partial(gmm_log_scores, normalizer=normalizer,
                           score_dtype=score_dtype)
    scores = jax.vmap(lambda xx: fn(xx, means, log_var, log_w))(x)
    return scores, x_mask


def mixture_mask(mix_counts: jax.Array, max_mix: int) -> jax.Array:
    """``[S, M]`` bool — True for active mixture slots.

    Per-unit mixture counts differ during mixture growth
    (``Controller.py:153-159``); the bank pads to ``max_mix_level`` and
    masks (SURVEY.md §7 hard part (f))."""
    return jnp.arange(max_mix)[None, :] < mix_counts[:, None]


def masked_log_w(log_w: jax.Array, mix_counts: jax.Array) -> jax.Array:
    """Force padded mixture slots to NEG_INF."""
    m = mixture_mask(mix_counts, log_w.shape[1])
    return jnp.where(m, log_w, NEG_INF)
