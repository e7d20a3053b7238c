"""Device meshes and collective reductions for distributed training.

Device-mesh replacement for the reference's entire distributed layer
(SURVEY.md §2 "parallelism strategies" / "distributed communication
backend"):

* multi-machine **data parallelism over utterances** (audio path shards,
  ``Controller.split_data``, ``Controller.py:79-106``) → the ``data``
  mesh axis: each device takes a slice of the utterance batch;
* multi-machine **model parallelism over units** (trainInfo complements,
  ``Controller.split_unit``, ``Controller.py:47-77``) → the ``state``
  mesh axis: the senone bank's GMM tensors shard over senones when they
  exceed one chip's HBM;
* the **file all-reduce** of EM accumulators (timestamped ``.npy`` files
  folded with ``matrix_log_sum_exp``, ``LHMM.py:211-290``,
  ``Clustering.py:257-367``) → one ``jax.lax.psum`` of the linear-domain
  statistics pytree over the cards' interconnect (NVLink);
* per-machine ``multiprocessing.Pool`` fan-out (``AcousticModel.py:708,
  790, 861``) → ``vmap`` inside each shard;
* ``Pool.join()`` barriers (``AcousticModel.py:714, 797, 870``) → the
  implicit barrier of the psum;
* multi-host process groups (the reference's by-hand ``ENV_ID`` machine
  identities, ``config.ini:26``) → ``jax.distributed.initialize``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map as _shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from poccala_tpu.train import accumulators as acc


def make_mesh(
    data_axis: int = -1,
    state_axis: int = 1,
    devices: list | None = None,
) -> Mesh:
    """Build a ``(data, state)`` mesh.

    :param data_axis: devices on the utterance-batch axis (-1: all
        remaining devices)
    :param state_axis: devices sharding the senone bank
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if data_axis == -1:
        assert n % state_axis == 0, (n, state_axis)
        data_axis = n // state_axis
    assert data_axis * state_axis == n, (data_axis, state_axis, n)
    arr = np.asarray(devices).reshape(data_axis, state_axis)
    return Mesh(arr, ("data", "state"))


def init_multihost(coordinator: str | None = None, num_processes: int | None = None,
                   process_id: int | None = None) -> None:
    """Join the multi-host process group (replaces the shared-directory
    machine coordination keyed by ``ENV_ID``, ``Controller.py:116-120``)."""
    kwargs = {}
    if coordinator is not None:
        kwargs["coordinator_address"] = coordinator
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


# ----------------------------------------------------------------------
# Sharding placements
# ----------------------------------------------------------------------

def replicate_bank(bank, mesh: Mesh):
    """Replicate the bank across the mesh (fits-on-one-chip case)."""
    sharding = NamedSharding(mesh, P())
    return jax.device_put(bank, sharding)


def shard_bank_states(bank, mesh: Mesh):
    """Shard the GMM tensors over the ``state`` axis (senone banks larger
    than one chip's HBM — BASELINE.json config 4).  Transition tensors
    are tiny and stay replicated."""
    import dataclasses

    gmm_spec = NamedSharding(mesh, P("state"))
    rep = NamedSharding(mesh, P())
    return dataclasses.replace(
        bank,
        means=jax.device_put(bank.means, gmm_spec),
        log_var=jax.device_put(bank.log_var, gmm_spec),
        log_w=jax.device_put(bank.log_w, gmm_spec),
        mix_counts=jax.device_put(bank.mix_counts, gmm_spec),
        log_A=jax.device_put(bank.log_A, rep),
        log_pi=jax.device_put(bank.log_pi, rep),
        senone_map=jax.device_put(bank.senone_map, rep),
    )


def pad_bank_states(bank, n_shards: int):
    """Pad the bank's senone axis to a multiple of ``n_shards`` so the
    GMM tensors divide evenly over the ``state`` mesh axis.  Padded
    senones have ``log_w = NEG_INF`` (they score -inf and are never
    referenced by ``senone_map``) and ``mix_counts = 0``.

    :returns: (padded bank, original senone count)
    """
    import dataclasses

    from poccala_tpu.utils.logmath import NEG_INF

    s = bank.means.shape[0]
    pad = (-s) % n_shards
    if pad == 0:
        return bank, s
    w = [(0, pad)]

    def p(a, fill=0.0):
        widths = w + [(0, 0)] * (a.ndim - 1)
        return jnp.pad(a, widths, constant_values=fill)

    return dataclasses.replace(
        bank,
        means=p(bank.means),
        log_var=p(bank.log_var),
        log_w=p(bank.log_w, NEG_INF),
        mix_counts=p(bank.mix_counts, 0),
    ), s


def unpad_bank_states(bank, s_orig: int):
    """Inverse of :func:`pad_bank_states`."""
    import dataclasses

    if bank.means.shape[0] == s_orig:
        return bank
    return dataclasses.replace(
        bank,
        means=bank.means[:s_orig],
        log_var=bank.log_var[:s_orig],
        log_w=bank.log_w[:s_orig],
        mix_counts=bank.mix_counts[:s_orig],
    )


def bank_pspec():
    """Partition specs for a :class:`SenoneBank`: GMM tensors sharded
    over ``state`` (rows = senones), transition tensors + senone map
    replicated (they are tiny — [U, N, N])."""
    from poccala_tpu.models.senone_bank import SenoneBank

    return SenoneBank(
        means=P("state"), log_var=P("state"), log_w=P("state"),
        log_A=P(), log_pi=P(), mix_counts=P("state"), senone_map=P(),
    )


def distribute_batch(mesh: Mesh, arrays: tuple, global_batch: int):
    """Assemble globally-sharded batch arrays from per-process local
    shards (multi-host: each host contributes its ``pathInfo`` slice,
    ``Controller.py:79-106``).  ``arrays`` hold this process's rows; the
    leading dim of the result is ``global_batch``."""
    out = []
    for a in arrays:
        a = np.asarray(a)
        sharding = NamedSharding(mesh, P("data"))
        out.append(
            jax.make_array_from_process_local_data(
                sharding, a, (global_batch,) + a.shape[1:]
            )
        )
    return tuple(out)


def pad_batch_for_mesh(arrays: tuple, mesh: Mesh):
    """Pad the leading (batch) dim of each array to a multiple of the
    ``data`` axis size; padded utterances get empty masks / zero label
    lengths so they contribute nothing to the psum'd statistics."""
    n_data = mesh.shape["data"]
    b = arrays[0].shape[0]
    pad = (-b) % n_data
    if pad == 0:
        return arrays, b
    out = []
    for a in arrays:
        widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        out.append(np.pad(np.asarray(a), widths))
    return tuple(out), b


# ----------------------------------------------------------------------
# Parallel E-step
# ----------------------------------------------------------------------

def make_parallel_estep(
    mesh: Mesh,
    state_num: int,
    max_label_len: int,
    normalizer: str = "textbook",
    count_final_exit: bool = True,
    bw_inner_iters: int = 1,
    score_dtype: str = "float32",
):
    """Build the jitted data-parallel E-step.

    Inside each shard: vmapped per-utterance embedded-BW statistics
    (:func:`poccala_tpu.train.accumulators.batch_stats`); across shards:
    ``psum`` over the ``data`` axis — the reference's accumulator-file
    fold as a single collective.

    Padded utterances (``label_len == 0``) produce all-zero statistics:
    their sentence HMM has no emitting states, so every mask is False.
    """

    def shard_fn(bank, labels, lens, xs, masks):
        stats, logliks = acc.batch_stats(
            bank, labels, lens, xs, masks, state_num, max_label_len,
            normalizer=normalizer, count_final_exit=count_final_exit,
            bw_inner_iters=bw_inner_iters, score_dtype=score_dtype,
        )
        stats = jax.tree.map(lambda a: jax.lax.psum(a, "data"), stats)
        return stats, logliks

    mapped = _shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P("data"), P("data"), P("data"), P("data")),
        out_specs=(P(), P("data")),
        check_vma=False,
    )
    return jax.jit(mapped)


def make_parallel_train_step(
    mesh: Mesh,
    state_num: int,
    max_label_len: int,
    c_covariance: float = 1e-6,
    normalizer: str = "textbook",
    count_final_exit: bool = True,
    bw_inner_iters: int = 1,
    update_transmat: bool = True,
    update_gmm: bool = True,
    score_dtype: str = "float32",
):
    """Full distributed EM step: parallel E-step + replicated M-step.

    Returns a jitted ``(bank, labels, lens, xs, masks) -> (bank', loglik)``.
    """
    estep = make_parallel_estep(
        mesh, state_num, max_label_len, normalizer,
        count_final_exit=count_final_exit, bw_inner_iters=bw_inner_iters,
        score_dtype=score_dtype,
    )

    @jax.jit
    def step(bank, labels, lens, xs, masks):
        stats, _ = estep(bank, labels, lens, xs, masks)
        new_bank = acc.apply_update(
            bank, stats,
            c_covariance=c_covariance,
            update_transmat=update_transmat,
            update_gmm=update_gmm,
        )
        return new_bank, stats.loglik

    return step


# ----------------------------------------------------------------------
# State-sharded E-step (real model parallelism over senones)
# ----------------------------------------------------------------------

def _stats_pspec():
    """Partition specs for :class:`BwStats`: GMM moments live on the
    senone (``state``) shards; transition stats / counters are identical
    on every state shard and replicated."""
    return acc.BwStats(
        occ=P("state"), c=P("state"), cx=P("state"), cxx=P("state"),
        trans=P(), trans_den=P(), loglik=P(), n_frames=P(), n_utts=P(),
    )


def make_state_sharded_estep(
    mesh: Mesh,
    state_num: int,
    max_label_len: int,
    normalizer: str = "textbook",
    count_final_exit: bool = True,
    bw_inner_iters: int = 1,
    score_dtype: str = "float32",
):
    """The E-step with the senone bank **actually sharded** over the
    ``state`` mesh axis (BASELINE config 4: mixture banks larger than one
    chip's HBM; the reference's unit partitioning across machines,
    ``Controller.py:47-77``).

    Unlike :func:`make_parallel_estep` (which replicates the bank), the
    GMM tensors enter the shard_map as ``P('state')`` — each device holds
    and scores only its ``S/K`` senone rows; the only cross-shard
    exchange is a ``pmax`` of the per-utterance ``[T, N_s]`` sentence
    score lattice (see ``accumulators.utterance_stats``
    ``state_axis_name``).  Returned GMM statistics stay sharded
    ``P('state')``; per-device memory and scoring FLOPs scale as 1/K.

    The bank's senone axis must divide the ``state`` axis size — use
    :func:`pad_bank_states`.
    """

    def shard_fn(bank, labels, lens, xs, masks):
        s_local = bank.means.shape[0]
        s_offset = jax.lax.axis_index("state") * s_local
        stats, logliks = acc.batch_stats(
            bank, labels, lens, xs, masks, state_num, max_label_len,
            normalizer=normalizer, count_final_exit=count_final_exit,
            bw_inner_iters=bw_inner_iters, score_dtype=score_dtype,
            state_axis_name="state", s_offset=s_offset,
        )
        stats = jax.tree.map(lambda a: jax.lax.psum(a, "data"), stats)
        return stats, logliks

    mapped = _shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(bank_pspec(), P("data"), P("data"), P("data"), P("data")),
        out_specs=(_stats_pspec(), P("data")),
        check_vma=False,
    )
    return jax.jit(mapped)


def make_state_sharded_align(
    mesh: Mesh,
    state_num: int,
    max_label_len: int,
    normalizer: str = "textbook",
    score_dtype: str = "float32",
):
    """Viterbi forced alignment with the senone bank sharded over the
    ``state`` axis (scheme 1 on BASELINE config-4 banks): each shard
    scores its local senones, the ``[T, N_s]`` sentence lattices are
    assembled with a ``pmax``, and the DP runs redundantly per shard —
    the full-S GMM tensors never materialize on any device
    (``Controller.py:47-77`` unit partitioning for the scheme-1 path)."""
    from poccala_tpu.train import alignment as align_mod

    def shard_fn(bank, labels, lens, xs, masks):
        s_local = bank.means.shape[0]
        s_offset = jax.lax.axis_index("state") * s_local
        return align_mod.align_batch(
            bank, labels, lens, xs, masks, state_num, max_label_len,
            normalizer=normalizer, score_dtype=score_dtype,
            state_axis_name="state", s_offset=s_offset,
        )

    mapped = _shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(bank_pspec(), P("data"), P("data"), P("data"), P("data")),
        out_specs=(P("data"), P("data")),
        check_vma=False,
    )
    return jax.jit(mapped)


def make_state_sharded_fit(
    mesh: Mesh,
    mix: int,
    max_mix: int,
    reinit: bool,
    c_covariance: float = 1e-6,
    converge_delta: float = 1.28,
    max_iters: int = 32,
    normalizer: str = "textbook",
):
    """Grouped k-means (re)init + EM with the senone axis sharded over
    ``state`` (the scheme-1 M-side of ``Trainer.fit_gmms``): the grouped
    program is per-senone independent, so each shard fits its local
    senones' GMMs on its local frame buckets — no collectives at all,
    and no full-S tensor on any device.

    Returns a jitted ``(key, frames, mask, means, log_var, log_w,
    mix_counts) -> (means, log_var, log_w, mix_counts)`` with every
    senone-axis argument/result ``P('state')``."""
    from poccala_tpu.ops import em as em_ops
    from poccala_tpu.ops import kmeans as km_ops
    from poccala_tpu.utils.logmath import masked_log

    def shard_fn(key, frames, mask, means, log_var, log_w, mix_counts):
        key = jax.random.fold_in(key, jax.lax.axis_index("state"))
        s_local = frames.shape[0]
        counts = mask.sum(axis=1)
        enough = counts >= max(mix, 2)
        means = means[:, :max_mix]
        if reinit:
            kres = km_ops.kmeans_grouped(key, frames, mask, k=mix)
            pad = max_mix - mix
            km_means = jnp.pad(kres["means"], ((0, 0), (0, pad), (0, 0)))
            km_logvar = jnp.pad(
                jnp.log(kres["variances"]), ((0, 0), (0, pad), (0, 0))
            )
            km_logw = masked_log(jnp.pad(kres["alpha"], ((0, 0), (0, pad))))
            sel = enough[:, None, None]
            means = jnp.where(sel, km_means, means)
            log_var = jnp.where(sel, km_logvar, log_var)
            log_w = jnp.where(enough[:, None], km_logw, log_w)
        mix_mask = jnp.tile(jnp.arange(max_mix)[None, :] < mix, (s_local, 1))
        params, _, _ = em_ops.em_fit_grouped(
            means, log_var, log_w, frames, mask, mix_mask,
            c_covariance=c_covariance,
            converge_delta=converge_delta,
            max_iters=max_iters,
            normalizer=normalizer,
        )
        sel = enough[:, None, None]
        return (
            jnp.where(sel, params.means, means),
            jnp.where(sel, params.log_var, log_var),
            jnp.where(enough[:, None], params.log_w, log_w),
            jnp.where(enough, mix, mix_counts).astype(jnp.int32),
        )

    mapped = _shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(),) + (P("state"),) * 6,
        out_specs=(P("state"),) * 4,
        check_vma=False,
    )
    return jax.jit(mapped)


def make_state_sharded_train_step(
    mesh: Mesh,
    state_num: int,
    max_label_len: int,
    c_covariance: float = 1e-6,
    normalizer: str = "textbook",
    count_final_exit: bool = True,
    bw_inner_iters: int = 1,
    update_transmat: bool = True,
    update_gmm: bool = True,
    score_dtype: str = "float32",
):
    """Full EM step with the senone bank sharded over ``state``: sharded
    E-step + **sharded M-step** (the GMM parameter update is elementwise
    per senone, so it runs on each shard's local rows; the tiny
    transition update is computed redundantly on every shard).  The bank
    never materializes unsharded anywhere in the step.
    """

    def shard_fn(bank, labels, lens, xs, masks):
        s_local = bank.means.shape[0]
        s_offset = jax.lax.axis_index("state") * s_local
        stats, _ = acc.batch_stats(
            bank, labels, lens, xs, masks, state_num, max_label_len,
            normalizer=normalizer, count_final_exit=count_final_exit,
            bw_inner_iters=bw_inner_iters, score_dtype=score_dtype,
            state_axis_name="state", s_offset=s_offset,
        )
        stats = jax.tree.map(lambda a: jax.lax.psum(a, "data"), stats)
        new_bank = acc.apply_update(
            bank, stats,
            c_covariance=c_covariance,
            update_transmat=update_transmat,
            update_gmm=update_gmm,
        )
        return new_bank, stats.loglik

    mapped = _shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(bank_pspec(), P("data"), P("data"), P("data"), P("data")),
        out_specs=(bank_pspec(), P()),
        check_vma=False,
    )
    return jax.jit(mapped)
