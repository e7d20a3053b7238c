"""GMM expectation-maximization, batched over senones.

Replaces ``Clustering.GMM.em`` (``StatisticalModel/Clustering.py:695-719``)
and its helpers ``expectation`` (``:583-599``), ``maximization``
(``:624-651``) and ``q_function`` (``:607-616``).

The reference runs EM per frame in log domain with a ``+100`` bias so
means stay positive under the log (``Clustering.py:103, 628-633``);
SURVEY.md §7 hard part (c) recommends scaled linear-domain statistics on
the device instead — responsibilities are posteriors in [0, 1], so γ-weighted
sums in float32 are well conditioned without bias tricks.  Covariances
are computed about the *new* mean, matching ``Clustering.py:638``, and
floored at ``c_covariance`` (``Clustering.py:641-645``).

Convergence: iterate until ΔQ ≤ 1.28 (``Clustering.py:706``) or
``max_iters``; batched via ``vmap`` with per-group freeze-once-converged.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from poccala_tpu.ops.gmm_score import gmm_component_logpdf
from poccala_tpu.utils.logmath import NEG_INF


class GmmParams(NamedTuple):
    means: jax.Array    # [M, D]
    log_var: jax.Array  # [M, D]
    log_w: jax.Array    # [M]


def e_step(params: GmmParams, x, mask, normalizer="textbook"):
    """Log responsibilities (``Clustering.expectation``,
    ``Clustering.py:583-599``): ``log γ[f, m] = log w_m + log N_m(x_f) -
    LSE_m'(...)``; masked frames get -inf."""
    comp = gmm_component_logpdf(
        x, params.means[None], params.log_var[None], normalizer=normalizer
    )[:, 0, :]  # [F, M]
    weighted = comp + params.log_w[None, :]
    log_gamma = weighted - jax.nn.logsumexp(weighted, axis=-1, keepdims=True)
    log_gamma = jnp.where(mask[:, None], log_gamma, NEG_INF)
    return log_gamma, comp


def q_value(log_gamma, comp, log_w):
    """EM Q function (``Clustering.q_function``, ``Clustering.py:607-616``):
    ``Σ_m N_m log α_m + Σ_{f,m} γ_fm log N_m(x_f)``."""
    gamma = jnp.exp(log_gamma)
    nk = gamma.sum(axis=0)  # [M]
    v1 = jnp.sum(nk * jnp.where(log_w > NEG_INF / 2, log_w, 0.0))
    v2 = jnp.sum(gamma * jnp.where(comp > NEG_INF / 2, comp, 0.0))
    return v1 + v2


def m_step(log_gamma, x, mask, c_covariance, mix_mask):
    """Maximization (``Clustering.maximization``, ``Clustering.py:624-651``)
    in linear domain: means = Σγx/Σγ, var about the new mean, floored;
    α = Σγ/F."""
    gamma = jnp.exp(log_gamma) * mask[:, None].astype(jnp.float32)  # [F, M]
    nk = gamma.sum(axis=0)  # [M]
    nk_safe = jnp.maximum(nk, 1e-10)
    means = jnp.dot(gamma.T, x, preferred_element_type=jnp.float32) / nk_safe[:, None]
    sq = jnp.dot(gamma.T, x * x, preferred_element_type=jnp.float32) / nk_safe[:, None]
    var = jnp.maximum(sq - means * means, c_covariance)
    n_valid = jnp.maximum(mask.sum().astype(jnp.float32), 1.0)
    alpha = nk / n_valid
    log_w = jnp.where(mix_mask, jnp.log(jnp.maximum(alpha, 1e-30)), NEG_INF)
    return GmmParams(means=means, log_var=jnp.log(var), log_w=log_w)


@functools.partial(
    jax.jit,
    static_argnames=("max_iters", "normalizer"),
)
def em_fit(
    params: GmmParams,
    x: jax.Array,
    mask: jax.Array,
    mix_mask: jax.Array,
    c_covariance: float = 1e-6,
    converge_delta: float = 1.28,
    max_iters: int = 20,
    normalizer: str = "textbook",
):
    """Run EM to convergence (ΔQ ≤ ``converge_delta``, ``Clustering.py:706``).

    :param x: ``[F, D]`` frames (padded); ``mask [F]``
    :param mix_mask: ``[M]`` active mixture slots
    :returns: (GmmParams, final Q, iterations run)
    """

    def cond(carry):
        _, _, dq, it = carry
        return (it < max_iters) & (dq > converge_delta)

    def body(carry):
        p, q, _, it = carry
        log_gamma, comp = e_step(p, x, mask, normalizer)
        new_p = m_step(log_gamma, x, mask, c_covariance, mix_mask)
        new_lg, new_comp = e_step(new_p, x, mask, normalizer)
        new_q = q_value(new_lg, new_comp, new_p.log_w)
        return new_p, new_q, new_q - q, it + 1

    init = (params, jnp.asarray(-jnp.inf, jnp.float32),
            jnp.asarray(jnp.inf, jnp.float32), jnp.asarray(0, jnp.int32))
    p, q, _, iters = jax.lax.while_loop(cond, body, init)
    return p, q, iters


def em_fit_grouped(
    params_means, params_log_var, params_log_w,
    x, mask, mix_mask,
    c_covariance: float = 1e-6,
    converge_delta: float = 1.28,
    max_iters: int = 20,
    normalizer: str = "textbook",
):
    """Batched EM over senone groups: arrays lead with a group axis G.

    Replaces the per-unit ``Pool.apply_async(multi_training)`` fan-out
    (``AcousticModel.py:790-797``) with one vmapped device program."""
    fn = functools.partial(
        em_fit,
        c_covariance=c_covariance,
        converge_delta=converge_delta,
        max_iters=max_iters,
        normalizer=normalizer,
    )

    def one(m, lv, lw, xx, mm, mxm):
        return fn(GmmParams(m, lv, lw), xx, mm, mxm)

    return jax.vmap(one)(params_means, params_log_var, params_log_w,
                         x, mask, mix_mask)
