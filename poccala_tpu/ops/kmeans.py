"""K-means clustering on the device: batched Lloyd iterations + k-means++ seeding.

Replaces ``Clustering.ClusterInitialization.kmeans``
(``StatisticalModel/Clustering.py:838-1044``): the reference's Lloyd
variant moves one point at a time with per-cluster hash dicts (O(F·k)
Python work per move); here assignment is a single ``[F, k]`` distance
matmul per iteration, batched over senones via ``vmap``.  Also subsumes
the declared-but-empty C++ hook ``ckmeans`` (``Clustering.py:1046-1051``)
— this *is* the compiled implementation.

Semantics kept from the reference:

* k-means++ seeding with distance-proportional sampling
  (``Clustering.py:975-1020``), including the degenerate all-points-equal
  fallback to uniform sampling (``Clustering.py:997-1009``);
* per-dimension variance floored at 1e-4 (``cal_variance``,
  ``Clustering.py:828-831``);
* returns (means, variances, alpha=cluster fractions, assignments)
  matching ``Clustering.py:941-961``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_VAR_FLOOR = 1e-4
_BIG = 1e30


def _pairwise_sq_dist(x, centers):
    """``[F, k]`` squared Euclidean distances in matmul form."""
    x2 = jnp.sum(x * x, axis=-1, keepdims=True)          # [F, 1]
    c2 = jnp.sum(centers * centers, axis=-1)             # [k]
    xc = jnp.dot(x, centers.T, preferred_element_type=jnp.float32)
    return x2 - 2.0 * xc + c2[None, :]


@functools.partial(jax.jit, static_argnames=("k",))
def kmeans_plusplus_init(key, x, mask, k: int):
    """k-means++ seeding (``Clustering.py:975-1020``).

    :param x: ``[F, D]`` points (padded), ``mask [F]`` validity
    :returns: ``[k, D]`` initial centers
    """
    f, d = x.shape
    maskf = mask.astype(jnp.float32)

    key, sub = jax.random.split(key)
    # first center: uniform over valid points
    p0 = maskf / jnp.maximum(maskf.sum(), 1.0)
    idx0 = jax.random.choice(sub, f, p=p0)
    centers0 = jnp.zeros((k, d), x.dtype).at[0].set(x[idx0])

    def body(i, carry):
        key, centers = carry
        dist = jnp.min(
            _pairwise_sq_dist(x, centers)
            + jnp.where(jnp.arange(k)[None, :] < i, 0.0, _BIG),
            axis=-1,
        )
        dist = jnp.sqrt(jnp.maximum(dist, 0.0)) * maskf
        total = dist.sum()
        key, sub = jax.random.split(key)
        # degenerate data (all points identical): uniform choice
        # (Clustering.py:997-1009)
        p = jnp.where(total > 0, dist / jnp.maximum(total, 1e-30), p0)
        idx = jax.random.choice(sub, f, p=p)
        return key, centers.at[i].set(x[idx])

    _, centers = jax.lax.fori_loop(1, k, body, (key, centers0))
    return centers


@functools.partial(jax.jit, static_argnames=("k", "iters"))
def kmeans(key, x, mask, k: int, iters: int = 20):
    """Lloyd k-means with k-means++ seeding.

    :param x: ``[F, D]`` points (padded); ``mask [F]`` validity
    :returns: dict with ``means [k, D]``, ``variances [k, D]`` (diagonal,
        floored at 1e-4), ``alpha [k]`` cluster fractions, ``assign [F]``
        (int32, valid where mask)
    """
    maskf = mask.astype(jnp.float32)
    n_valid = jnp.maximum(maskf.sum(), 1.0)
    centers = kmeans_plusplus_init(key, x, mask, k)

    def step(centers, _):
        dist = _pairwise_sq_dist(x, centers)
        assign = jnp.argmin(dist, axis=-1)
        onehot = jax.nn.one_hot(assign, k, dtype=jnp.float32) * maskf[:, None]
        counts = onehot.sum(axis=0)  # [k]
        sums = jnp.dot(onehot.T, x, preferred_element_type=jnp.float32)
        new = sums / jnp.maximum(counts[:, None], 1.0)
        # empty cluster: re-seed at the point farthest from its center
        far = jnp.argmax(jnp.min(dist, axis=-1) * maskf)
        new = jnp.where((counts > 0)[:, None], new, x[far][None, :])
        return new, None

    centers, _ = jax.lax.scan(step, centers, None, length=iters)

    dist = _pairwise_sq_dist(x, centers)
    assign = jnp.argmin(dist, axis=-1).astype(jnp.int32)
    onehot = jax.nn.one_hot(assign, k, dtype=jnp.float32) * maskf[:, None]
    counts = onehot.sum(axis=0)
    sums = jnp.dot(onehot.T, x, preferred_element_type=jnp.float32)
    means = sums / jnp.maximum(counts[:, None], 1.0)
    # clusters that stayed empty keep their (re-seeded) center
    means = jnp.where((counts > 0)[:, None], means, centers)
    sq = jnp.dot(onehot.T, x * x, preferred_element_type=jnp.float32)
    variances = sq / jnp.maximum(counts[:, None], 1.0) - means * means
    variances = jnp.where(
        (counts > 0)[:, None], jnp.maximum(variances, _VAR_FLOOR), _VAR_FLOOR
    )
    alpha = counts / n_valid
    return {
        "means": means,
        "variances": variances,
        "alpha": alpha,
        "assign": jnp.where(mask, assign, -1),
        "counts": counts,
    }


def kmeans_grouped(key, x, mask, k: int, iters: int = 20):
    """Batched k-means over groups: ``x [G, F, D]``, ``mask [G, F]`` —
    one independent clustering per group (e.g. per senone during
    mixture re-initialization, ``AcousticModel.__cal_gmm``,
    ``AcousticModel.py:552-558``)."""
    g = x.shape[0]
    keys = jax.random.split(key, g)
    fn = functools.partial(kmeans, k=k, iters=iters)
    return jax.vmap(fn)(keys, x, mask)
