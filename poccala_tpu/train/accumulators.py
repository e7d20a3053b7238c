"""Embedded Baum-Welch sufficient statistics as pure-function pytrees.

Replaces the reference's file-based accumulator machinery:
``LHMM.update_acc`` scatters sentence-level ksai/gamma windows into each
sub-HMM and γ-weighted frames into each GMM's log-domain accumulators
(``LHMM.py:473-507`` → ``Clustering.py:653-680``), which are persisted as
timestamped ``.npy`` files and folded back with ``matrix_log_sum_exp``
(``LHMM.py:211-290``, ``Clustering.py:257-367``) — the "file all-reduce"
(SURVEY.md §2).

Here the statistics are one linear-domain pytree per batch:

* γ-weighted zeroth/first/second moments per (senone, mixture) —
  ``c``, ``cx``, ``cxx`` (second moments are raw; the covariance update
  recenters about the *old* mean exactly as ``Clustering.py:677, 688``);
* transition numerators/denominators scattered from sentence rows back
  to per-unit (row, col) slots via ``segment_sum``.

Accumulators are associative and commutative, so cross-device reduction
is a single ``psum`` (``poccala_tpu.parallel``), and cross-batch folding
is ``jax.tree.map(add)``.  Per-utterance statistics are normalized by
P(O|λ) (the reference normalizes its GMM stats the same way via the
per-time state normalizer, ``LHMM.py:488``, but leaves ksai/gamma
unnormalized — a P(O)-weighting quirk we do not inherit; ratios per
utterance are identical).
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from poccala_tpu.models.senone_bank import SenoneBank
from poccala_tpu.models.topology import EmbeddedHMM, build_embedded
from poccala_tpu.ops import hmm as hmm_ops
from poccala_tpu.ops.gmm_score import gmm_component_logpdf
from poccala_tpu.utils.logmath import NEG_INF, masked_log


@jax.tree_util.register_dataclass
@dataclass
class BwStats:
    """Linear-domain Baum-Welch sufficient statistics."""

    occ: jax.Array        # [S]        Σ_t γ_t(s)
    c: jax.Array          # [S, M]     Σ_t γ_t(s, m)
    cx: jax.Array         # [S, M, D]  Σ_t γ_t(s, m) · x_t
    cxx: jax.Array        # [S, M, D]  Σ_t γ_t(s, m) · x_t²
    trans: jax.Array      # [U, N, N]  ξ sums per unit transition
    trans_den: jax.Array  # [U, N]     Σ_{t<T-1} γ_t per unit state
    loglik: jax.Array     # scalar     Σ_utt log P(O|λ)
    n_frames: jax.Array   # scalar     Σ_utt T_true
    n_utts: jax.Array     # scalar


def zero_stats(bank: SenoneBank) -> BwStats:
    s, m, d = bank.means.shape
    u, n, _ = bank.log_A.shape
    z = jnp.zeros
    return BwStats(
        occ=z((s,)), c=z((s, m)), cx=z((s, m, d)), cxx=z((s, m, d)),
        trans=z((u, n, n)), trans_den=z((u, n)),
        loglik=z(()), n_frames=z(()), n_utts=z(()),
    )


def add_stats(a: BwStats, b: BwStats) -> BwStats:
    return jax.tree.map(jnp.add, a, b)


# ----------------------------------------------------------------------
# Per-utterance E step
# ----------------------------------------------------------------------

@functools.partial(
    jax.jit,
    static_argnames=("state_num", "max_label_len", "normalizer",
                     "count_final_exit", "bw_inner_iters",
                     "state_axis_name", "score_dtype"),
)
def utterance_stats(
    bank: SenoneBank,
    label: jax.Array,       # [L_max] int32 unit ids
    label_len: jax.Array,   # scalar int32
    x: jax.Array,           # [T, D] features (padded)
    t_mask: jax.Array,      # [T] bool
    state_num: int,
    max_label_len: int,
    normalizer: str = "textbook",
    count_final_exit: bool = True,
    bw_inner_iters: int = 1,
    bw_converge_delta: float = 0.64,
    state_axis_name: str | None = None,
    s_offset: jax.Array | int = 0,
    score_dtype: str = "float32",
) -> tuple[BwStats, jax.Array]:
    """One utterance's Baum-Welch statistics (the map side of the
    reference's map-reduce EM step, ``multi_embedded_training_1``,
    ``AcousticModel.py:884-916``).

    ``count_final_exit``: the sentence exit state carries -inf emission
    (``VirtualState(0.)``, ``AcousticModel.py:219``), so in the
    reference's scheme the exit transition of sentence-final units is
    never observed and Baum-Welch drives their exit probability to zero
    — syllables then can never end during decoding (a latent defect of
    the reference).  With the flag on (default) we count the HTK-style
    final-frame flow into the exit state, ``ξ(r→exit) ∝ α_{T-1}(r) ·
    a(r→exit)``, with matching final-frame occupancy in the denominator;
    transition rows are renormalized at update time.  Set False to
    reproduce the reference's statistics exactly.

    ``bw_inner_iters > 1`` reproduces the reference's per-utterance
    ``baulm_welch`` inner loop (``LHMM.py:526-544``): the *embedded*
    sentence HMM's pi is re-estimated from γ₀ and forward/backward is
    re-run until the utterance log-likelihood improves by ≤
    ``bw_converge_delta`` (the reference's 0.64, ``LHMM.py:539``) or the
    iteration cap; statistics are then taken at the converged pi.  The
    default (1) is the textbook single E-step with uniform sentence pi.

    ``state_axis_name``: when set (inside a ``shard_map`` whose mesh has
    that axis), the bank's GMM tensors (``means/log_var/log_w``) are the
    **local senone shard** — ``[S_local, M, D]`` rows ``[s_offset,
    s_offset + S_local)`` of the global bank — while ``log_A`` /
    ``senone_map`` stay replicated.  This is the device-mesh form of the
    reference's multi-machine unit partitioning (``Controller.py:47-77``):
    each shard scores only the sentence states whose senone it owns, the
    shards exchange the tiny ``[T, N_s]`` score lattice with a ``pmax``
    (exactly one shard owns each senone; everyone else holds NEG_INF),
    the forward/backward DP is computed redundantly on every shard
    (negligible vs. scoring), and the returned GMM statistics are
    **local** (``occ[S_local]`` …) so memory and FLOPs both scale as
    1/num_shards.  Transition statistics are identical across shards.

    :returns: (stats, log P(O|λ))
    """
    emit = state_num - 2
    s_local, m, d = bank.means.shape
    u_total, n, _ = bank.log_A.shape
    t_pad = x.shape[0]

    ehmm = build_embedded(bank, label, label_len, state_num, max_label_len)
    n_s = ehmm.senone_idx.shape[0]
    r = jnp.arange(n_s)

    # --- component scores only for this sentence's states (gather keeps
    # the lattice [T, N_s, M] small instead of [T, S, M])
    if state_axis_name is None:
        sen = jnp.clip(ehmm.senone_idx, 0, s_local - 1)
        owned = ehmm.senone_idx >= 0
        comp = gmm_component_logpdf(
            x, bank.means[sen], bank.log_var[sen], normalizer=normalizer,
            score_dtype=score_dtype,
        ) + bank.log_w[sen][None]                   # [T, N_s, M]
        scores = jax.nn.logsumexp(comp, axis=-1)    # [T, N_s]
    else:
        lsen_raw = ehmm.senone_idx - s_offset
        owned = (lsen_raw >= 0) & (lsen_raw < s_local) & (ehmm.senone_idx >= 0)
        sen = jnp.clip(lsen_raw, 0, s_local - 1)
        comp = gmm_component_logpdf(
            x, bank.means[sen], bank.log_var[sen], normalizer=normalizer,
            score_dtype=score_dtype,
        ) + bank.log_w[sen][None]
        comp = jnp.where(owned[None, :, None], comp, NEG_INF)
        # exchange the [T, N_s] lattice, NOT the bank: pmax assembles the
        # full sentence scores from per-shard partial rows
        scores = jax.lax.pmax(
            jax.nn.logsumexp(comp, axis=-1), state_axis_name
        )
    is_entry = r == 0
    is_exit = r == ehmm.n_states - 1
    emitting = ehmm.senone_idx >= 0
    log_b = jnp.where(emitting[None, :], scores, NEG_INF)
    log_b = jnp.where(is_entry[None, :], 0.0, log_b)
    log_b = jnp.where((is_exit | ~ehmm.state_mask)[None, :], NEG_INF, log_b)

    # --- forward / backward (banded)
    def fb(log_pi):
        la, ll = hmm_ops.forward_log_banded(
            ehmm.band, log_pi, log_b, t_mask, state_num
        )
        lb = hmm_ops.backward_log_banded(ehmm.band, log_b, t_mask, state_num)
        return la, lb, ll

    log_pi_used = ehmm.log_pi
    if bw_inner_iters > 1:
        # per-utterance inner loop re-estimating the sentence pi
        # (LHMM.py:526-544; see docstring)
        la0, lb0, ll0 = fb(log_pi_used)
        g0 = la0[0] + lb0[0]

        def new_pi(g0):
            norm = jax.nn.logsumexp(jnp.where(ehmm.state_mask, g0, NEG_INF))
            pi = g0 - norm
            return jnp.where(
                ehmm.state_mask & (pi > NEG_INF / 2), pi, NEG_INF
            )

        def cond(carry):
            _, prev_ll, cur_ll, _, it = carry
            return (it < bw_inner_iters) & (cur_ll - prev_ll > bw_converge_delta)

        def body(carry):
            log_pi, _, cur_ll, g0, it = carry
            pi = new_pi(g0)
            la, lb, ll = fb(pi)
            return (pi, cur_ll, ll, la[0] + lb[0], it + 1)

        log_pi_used, _, _, _, _ = jax.lax.while_loop(
            cond, body,
            (log_pi_used, jnp.asarray(-jnp.inf), ll0, g0,
             jnp.asarray(1, jnp.int32)),
        )

    log_alpha, log_beta, loglik = fb(log_pi_used)

    # --- state posteriors γ_t(r), normalized by P(O)
    log_gamma = log_alpha + log_beta - loglik
    gamma = jnp.where(
        t_mask[:, None] & ehmm.state_mask[None, :] & (log_gamma > NEG_INF / 2),
        jnp.exp(jnp.minimum(log_gamma, 0.0)),
        0.0,
    )  # [T, N_s]

    # --- GMM statistics (LHMM.update_acc -> GMM.update_acc,
    #     LHMM.py:497-505, Clustering.py:653-680)
    # mixture posterior within a state: exp(comp - log_b)
    comp_post = jnp.exp(
        jnp.minimum(comp - scores[:, :, None], 0.0)
    )
    gamma_rm = gamma[:, :, None] * comp_post        # [T, N_s, M]
    gamma_rm = jnp.where(emitting[None, :, None], gamma_rm, 0.0)
    c_r = gamma_rm.sum(axis=0)                      # [N_s, M]
    cx_r = jnp.einsum("trm,td->rmd", gamma_rm, x)   # [N_s, M, D]
    cxx_r = jnp.einsum("trm,td->rmd", gamma_rm, x * x)
    occ_r = jnp.where(emitting, gamma.sum(axis=0), 0.0)  # [N_s]

    # dummy bucket for virtual states and (in sharded mode) senones owned
    # by another state shard — local statistics stay [S_local]
    seg = jnp.where(emitting & owned, sen, s_local)
    occ = jax.ops.segment_sum(occ_r, seg, num_segments=s_local + 1)[:s_local]
    c = jax.ops.segment_sum(c_r, seg, num_segments=s_local + 1)[:s_local]
    cx = jax.ops.segment_sum(cx_r, seg, num_segments=s_local + 1)[:s_local]
    cxx = jax.ops.segment_sum(cxx_r, seg, num_segments=s_local + 1)[:s_local]

    # --- transition statistics (LHMM.__maximization cal_ksai/cal_gamma,
    #     LHMM.py:431-445, normalized by P(O))
    # ξ_t(r, k) = exp(α_t(r) + band[r,k] + b_{t+1}(r+k) + β_{t+1}(r+k) - logP)
    t_next_valid = t_mask[1:]  # transition t -> t+1 exists iff t+1 valid
    s_next = log_b[1:] + log_beta[1:]               # [T-1, N_s]
    ksai_k = []
    for k in range(state_num):
        shifted = jnp.pad(
            s_next[:, k:], ((0, 0), (0, k)), constant_values=NEG_INF
        )  # s_next[t, r+k]
        log_ksai = (
            log_alpha[:-1] + ehmm.band[None, :, k] + shifted - loglik
        )
        ksai = jnp.where(
            t_next_valid[:, None] & (log_ksai > NEG_INF / 2),
            jnp.exp(jnp.minimum(log_ksai, 0.0)),
            0.0,
        )
        ksai_k.append(ksai.sum(axis=0))             # [N_s]
    ksai_rk = jnp.stack(ksai_k, axis=-1)            # [N_s, W]

    # γ denominator over t in [0, T-2] (LHMM.py:442-445)
    gamma_den_r = (gamma[:-1] * t_next_valid[:, None]).sum(axis=0)  # [N_s]

    if count_final_exit:
        # final-frame exit flow (see docstring).  Padded timesteps carry
        # the last valid alpha forward, so log_alpha[-1] == α_{T_true-1}.
        alpha_last = log_alpha[-1]
        k_off = jnp.arange(state_num)[None, :]
        into_exit = (jnp.arange(n_s)[:, None] + k_off) == (ehmm.n_states - 1)
        log_ksai_exit = alpha_last[:, None] + ehmm.band - loglik
        ksai_exit = jnp.where(
            into_exit & (log_ksai_exit > NEG_INF / 2),
            jnp.exp(jnp.minimum(log_ksai_exit, 0.0)),
            0.0,
        )
        ksai_rk = ksai_rk + ksai_exit
        gamma_last = jnp.where(
            (alpha_last - loglik) > NEG_INF / 2,
            jnp.exp(jnp.minimum(alpha_last - loglik, 0.0)),
            0.0,
        )
        gamma_den_r = gamma_den_r + gamma_last

    # scatter sentence rows -> per-unit (row, col) slots; only emitting
    # rows update (transmat[1:-1] re-estimation, LHMM.py:519-520)
    pos = jnp.clip(r - 1, 0, None)
    local = pos % emit + 1
    unit = label[jnp.clip(pos // emit, 0, max_label_len - 1)]
    k_idx = jnp.arange(state_num)[None, :]
    local_col = local[:, None] + k_idx
    valid_rk = emitting[:, None] & (local_col < n)
    flat_idx = unit[:, None] * (n * n) + local[:, None] * n + jnp.clip(
        local_col, 0, n - 1
    )
    flat_idx = jnp.where(valid_rk, flat_idx, u_total * n * n)
    trans = jax.ops.segment_sum(
        jnp.where(valid_rk, ksai_rk, 0.0).reshape(-1),
        flat_idx.reshape(-1),
        num_segments=u_total * n * n + 1,
    )[:-1].reshape(u_total, n, n)

    den_idx = jnp.where(emitting, unit * n + local, u_total * n)
    trans_den = jax.ops.segment_sum(
        gamma_den_r, den_idx, num_segments=u_total * n + 1
    )[:-1].reshape(u_total, n)

    stats = BwStats(
        occ=occ, c=c, cx=cx, cxx=cxx, trans=trans, trans_den=trans_den,
        loglik=loglik, n_frames=t_mask.sum().astype(jnp.float32),
        n_utts=jnp.asarray(1.0),
    )
    return stats, loglik


def batch_stats(
    bank, labels, label_lens, xs, t_masks, state_num, max_label_len,
    normalizer: str = "textbook", count_final_exit: bool = True,
    bw_inner_iters: int = 1,
    state_axis_name: str | None = None, s_offset: jax.Array | int = 0,
    score_dtype: str = "float32",
):
    """vmap + fold of :func:`utterance_stats` over a batch (the
    ``Pool``-of-utterances map phase, ``AcousticModel.py:861-870``)."""
    fn = functools.partial(
        utterance_stats,
        state_num=state_num,
        max_label_len=max_label_len,
        normalizer=normalizer,
        count_final_exit=count_final_exit,
        bw_inner_iters=bw_inner_iters,
        state_axis_name=state_axis_name,
        s_offset=s_offset,
        score_dtype=score_dtype,
    )
    stats, logliks = jax.vmap(
        lambda l, n, x, m: fn(bank, l, n, x, m)
    )(labels, label_lens, xs, t_masks)
    # batch-padding utterances (label_len == 0) contribute nothing
    real = (label_lens > 0).astype(jnp.float32)
    total = jax.tree.map(
        lambda a: (a * real.reshape((-1,) + (1,) * (a.ndim - 1))).sum(axis=0),
        stats,
    )
    return total, logliks


# ----------------------------------------------------------------------
# M step (parameter re-estimation)
# ----------------------------------------------------------------------

@functools.partial(
    jax.jit, static_argnames=("update_transmat", "update_gmm")
)
def apply_update(
    bank: SenoneBank,
    stats: BwStats,
    c_covariance: float = 1e-6,
    min_occ: float = 1e-3,
    update_transmat: bool = True,
    update_gmm: bool = True,
) -> SenoneBank:
    """Re-estimate bank parameters from folded statistics (the reduce
    side: ``LHMM.update_param`` + ``GMM.update_param``,
    ``LHMM.py:509-524``, ``Clustering.py:682-693``).

    * transitions: ``A[u, 1:-1, :] = ξ/γ`` per row; rows/senones with no
      occupancy keep their old values (missing-acc no-op guard,
      ``LHMM.py:267-271, 517-518``);
    * GMM: ``α = c/occ``, ``μ = cx/c``, ``σ² = Σγ(x-μ_old)²/c`` recentered
      from raw moments about the *old* mean (``Clustering.py:677, 688``),
      floored at ``c_covariance`` (``Clustering.py:689-693``);
    * ``fix_code`` parameter freezing (``LHMM.py:35-36, 140-146``) maps to
      the ``update_transmat`` / ``update_gmm`` flags (pi is never
      re-estimated by embedded training in the reference either).
    """
    out = bank
    n = bank.state_num

    if update_transmat:
        den = stats.trans_den[:, :, None]
        row_ok = den > min_occ
        a_new = jnp.where(row_ok, stats.trans / jnp.maximum(den, min_occ), 0.0)
        # renormalize rows: exact stochasticity under the final-exit
        # counting (and guards accumulation drift either way)
        rowsum = a_new.sum(axis=-1, keepdims=True)
        a_new = jnp.where(rowsum > 0, a_new / jnp.maximum(rowsum, 1e-30), a_new)
        log_a_new = masked_log(a_new)
        # only emitting rows update
        row_idx = jnp.arange(n)[None, :, None]
        is_emit_row = (row_idx >= 1) & (row_idx <= n - 2)
        log_a = jnp.where(is_emit_row & row_ok, log_a_new, bank.log_A)
        out = dataclasses.replace(out, log_A=log_a)

    if update_gmm:
        occ_ok = stats.occ > min_occ                     # [S]
        c_ok = stats.c > min_occ                         # [S, M]
        c_safe = jnp.maximum(stats.c, min_occ)[..., None]

        mean_new = stats.cx / c_safe
        mu_old = bank.means
        var_new = (
            stats.cxx - 2.0 * mu_old * stats.cx + mu_old * mu_old * stats.c[..., None]
        ) / c_safe
        var_new = jnp.maximum(var_new, c_covariance)

        upd = occ_ok[:, None, None] & c_ok[..., None]
        means = jnp.where(upd, mean_new, bank.means)
        log_var = jnp.where(upd, jnp.log(var_new), bank.log_var)

        alpha_new = stats.c / jnp.maximum(stats.occ, min_occ)[:, None]
        log_w_new = masked_log(alpha_new)
        active = bank.log_w > NEG_INF / 2
        log_w = jnp.where(occ_ok[:, None] & c_ok & active, log_w_new, bank.log_w)
        out = dataclasses.replace(out, means=means, log_var=log_var, log_w=log_w)

    return out
