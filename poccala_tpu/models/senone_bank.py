"""The senone bank: all units' HMM+GMM parameters as one pytree.

Design inversion (SURVEY.md §7): the reference holds one Python object
tree per unit — an ``LHMM`` wrapping per-state ``Clustering.GMM``
instances, each persisting its own ``.npy`` files
(``AcousticModel.py:164-226``).  Here all of it becomes a single
batched pytree so every per-unit loop is a batched axis:

* ``means[S, M, D]``, ``log_var[S, M, D]``, ``log_w[S, M]`` — the GMMs of
  all emitting states; ``senone_map[U, state_num-2]`` maps (unit,
  emitting state) to its senone (identity layout when untied,
  data-driven sharing when tied);
* ``log_A[U, N, N]`` — per-unit transition matrices (N = state_num,
  rows 0 and N-1 are the virtual entry/exit states,
  ``AcousticModel.py:174-181``);
* ``log_pi[U, N]`` — per-unit initial distributions (the reference's
  ``LHMM`` default is uniform, ``LHMM.py:63-67``);
* ``mix_counts[S]`` — active mixtures per senone; the mixture axis is
  padded to ``max_mix_level`` and masked (SURVEY.md §7 hard part (f)).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from poccala_tpu.config import ModelConfig
from poccala_tpu.utils.logmath import NEG_INF, masked_log


@jax.tree_util.register_dataclass
@dataclass
class SenoneBank:
    means: jax.Array      # [S, M, D] float32
    log_var: jax.Array    # [S, M, D] float32
    log_w: jax.Array      # [S, M]    float32 (NEG_INF on padded slots)
    log_A: jax.Array      # [U, N, N] float32
    log_pi: jax.Array     # [U, N]    float32
    mix_counts: jax.Array  # [S]      int32
    # state tying (BASELINE config 3 "tied-state" units): maps
    # (unit, emitting-state index) -> senone id.  The untied default is
    # the identity layout ``u * (N-2) + e``; tying makes S independent
    # of U and lets multiple unit states share one GMM — Baum-Welch
    # statistics accumulate onto shared senones automatically because
    # every scatter keys on this map.
    senone_map: jax.Array  # [U, N-2]  int32

    # ------------------------------------------------------------------
    @property
    def num_states(self) -> int:
        return self.means.shape[0]

    @property
    def max_mix(self) -> int:
        return self.means.shape[1]

    @property
    def dim(self) -> int:
        return self.means.shape[2]

    @property
    def num_units(self) -> int:
        return self.log_A.shape[0]

    @property
    def state_num(self) -> int:
        return self.log_A.shape[1]

    @property
    def emit_states(self) -> int:
        return self.state_num - 2

    def senone_id(self, unit: int, emit: int) -> int:
        return int(self.senone_map[unit, emit])


def identity_senone_map(num_units: int, emit: int) -> jnp.ndarray:
    """The untied layout: senone(u, e) = u * emit + e."""
    return (jnp.arange(num_units)[:, None] * emit
            + jnp.arange(emit)[None, :]).astype(jnp.int32)


def unit_transmat(state_num: int) -> np.ndarray:
    """Left-to-right unit topology (``AcousticModel.py:176-181``):
    virtual entry 0 -> 1 with prob 1; emitting states 0.5 self / 0.5
    next; virtual exit absorbing."""
    a = np.zeros((state_num, state_num))
    a[0, 1] = 1.0
    for j in range(1, state_num - 1):
        a[j, j] = 0.5
        a[j, j + 1] = 0.5
    return a


def create_bank(
    num_units: int,
    cfg: ModelConfig,
    dim: int,
    key: jax.Array | None = None,
    mix_level: int | None = None,
    differentiation: bool = True,
) -> SenoneBank:
    """Fresh bank with the reference's initial values
    (``AcousticModel.init_unit`` -> ``Clustering.GMM.__init__``,
    ``Clustering.py:66-90``): random means in [0,1) when
    ``differentiation`` else zeros; unit diagonal covariance; uniform
    mixture weights; the standard unit transmat; uniform pi."""
    n = cfg.state_num
    emit = n - 2
    s = num_units * emit
    m = cfg.max_mix_level
    active = mix_level if mix_level is not None else cfg.mix_level

    if key is None:
        key = jax.random.PRNGKey(0)
    if differentiation:
        means = jax.random.uniform(key, (s, m, dim), dtype=jnp.float32)
    else:
        means = jnp.zeros((s, m, dim), jnp.float32)
    log_var = jnp.zeros((s, m, dim), jnp.float32)  # identity covariance
    mix_counts = jnp.full((s,), active, jnp.int32)
    w = jnp.where(
        jnp.arange(m)[None, :] < active, 1.0 / active, 0.0
    ) * jnp.ones((s, 1))
    log_w = masked_log(w)

    log_a = masked_log(jnp.asarray(unit_transmat(n), jnp.float32))
    log_a = jnp.tile(log_a[None], (num_units, 1, 1))
    log_pi = jnp.full((num_units, n), -jnp.log(float(n)), jnp.float32)
    return SenoneBank(
        means=means, log_var=log_var, log_w=log_w,
        log_A=log_a, log_pi=log_pi, mix_counts=mix_counts,
        senone_map=identity_senone_map(num_units, emit),
    )


def flat_start(
    bank: SenoneBank,
    global_mean: jax.Array,
    global_var: jax.Array,
    key: jax.Array,
    coefficient: float = 1.0,
    differentiation: bool = True,
) -> SenoneBank:
    """Flat start (``AcousticModel.__flat_start``,
    ``AcousticModel.py:479-517``): every senone's GMM gets the global
    mean/covariance; mixture means are differentiated by a random
    per-mixture offset ``diff * diag(cov)`` drawn once and shared by all
    senones (the reference draws ``diff_coefficient`` outside the unit
    loop, ``AcousticModel.py:504-509``)."""
    s, m, d = bank.means.shape
    if differentiation:
        u1 = jax.random.uniform(key, (m, 1))
        u2 = jax.random.uniform(jax.random.fold_in(key, 1), (m, 1))
        diff = (u1 - u2) * coefficient  # [M, 1], in (-c, c)
    else:
        diff = jnp.zeros((m, 1))
    # mean_m[j] = global_mean + diff_j * diag(global_cov) (AcousticModel.py:514)
    mean_m = global_mean[None, :] + diff * global_var[None, :]
    means = jnp.tile(mean_m[None], (s, 1, 1)).astype(jnp.float32)
    log_var = jnp.tile(
        jnp.log(jnp.maximum(global_var, 1e-10))[None, None], (s, m, 1)
    ).astype(jnp.float32)
    return dataclasses.replace(bank, means=means, log_var=log_var)


# ----------------------------------------------------------------------
# Mixture growth (Controller.add_mix_level, Controller.py:153-159)
# ----------------------------------------------------------------------

def grow_mixtures(bank: SenoneBank, new_counts: jax.Array) -> SenoneBank:
    """Record new per-senone mixture targets.  The actual re-clustering
    happens at the next k-means init (``AcousticModel.__cal_gmm``
    re-clusters when ``gmm.mixture != mix_level``,
    ``AcousticModel.py:552-558``); here we only bump the counts and
    renormalize masked weights."""
    new_counts = jnp.minimum(new_counts, bank.max_mix)
    return dataclasses.replace(bank, mix_counts=new_counts.astype(jnp.int32))
