"""Training orchestration: the two schemes of the reference's
``Task.auto`` (``Controller.py:161-202``), batched on the device.

Scheme 1 (``Controller.py:167-173``, isolated-word style):
  1. init: uniform segmentation collects per-unit data
     (``__eq_segment`` mode 'e'); per-senone GMMs are k-means-initialized
     and EM-trained (``multi_training`` → ``__cal_gmm``), with optional
     SMEM on the init round (``AcousticModel.py:835``);
  2. re-estimation: Viterbi forced alignment re-collects data
     (``multi_process_data``), GMM EM re-runs; mixtures may grow between
     rounds, forcing k-means re-clustering (``AcousticModel.py:552-558``);
  3. each round ends with embedded training that re-estimates *only* the
     transition matrices (fix_code=2, ``AcousticModel.py:789-803``).

Scheme 2 (``Controller.py:174-178``, continuous-speech style):
  flat start (global mean/cov for every GMM) then embedded Baum-Welch
  over sentence HMMs, all parameters free (fix_code=0).

The map-reduce structure of both schemes (utterance map → accumulator
files → unit reduce, SURVEY.md §3.2) is here a vmapped E-step plus a
pytree fold; the file all-reduce becomes ``add_stats``/``psum``.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Iterable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from poccala_tpu.config import Config
from poccala_tpu.io.corpus import Batch, UnitInventory
from poccala_tpu.models import senone_bank as sb
from poccala_tpu.ops import em as em_ops
from poccala_tpu.ops import kmeans as km_ops
from poccala_tpu.train import accumulators as acc
from poccala_tpu.train import alignment as align
from poccala_tpu.utils.errors import ModeError
from poccala_tpu.utils.logging import get_logger
from poccala_tpu.utils.logmath import masked_log


class Trainer:
    """Single-host trainer over a senone bank.

    Multi-device data parallelism wraps the E-step via
    :mod:`poccala_tpu.parallel`; this class is the sequential driver.
    """

    def __init__(
        self,
        cfg: Config,
        inventory: UnitInventory,
        key: jax.Array | None = None,
        logger: logging.Logger | None = None,
        mesh=None,
    ):
        """:param mesh: optional ``jax.sharding.Mesh`` with a ``data``
        axis — the E-step then runs data-parallel with psum'd statistics
        (:mod:`poccala_tpu.parallel`)."""
        self.cfg = cfg
        self.inventory = inventory
        self.log = logger or get_logger("trainer", cfg.paths.env_id)
        self.key = key if key is not None else jax.random.PRNGKey(cfg.train.seed)
        self.bank = sb.create_bank(
            len(inventory), cfg.model, cfg.frontend.feat_dim, key=self._next_key()
        )
        self.mix_level = cfg.model.mix_level
        self.history: list[dict] = []
        # effective covariance floor: the reference's scalar, or (flag-
        # gated) a per-dim relative floor computed from the corpus on
        # first use (ModelConfig.var_floor_scale); np constant so jit /
        # shard_map closures embed it as a literal
        self._var_floor_vec: np.ndarray | None = None
        self.mesh = mesh
        self._parallel_estep = None
        self._s_orig = self.bank.num_states
        self.state_shards = 1
        if mesh is not None:
            from poccala_tpu.parallel import mesh as pmesh

            self.state_shards = int(dict(mesh.shape).get("state", 1))
            if self.state_shards > 1:
                # real model parallelism: the bank's GMM tensors shard
                # over senones (Controller.py:47-77 unit partitioning);
                # per-device memory/FLOPs scale as 1/state_shards
                self.bank, self._s_orig = pmesh.pad_bank_states(
                    self.bank, self.state_shards
                )
                self.bank = pmesh.shard_bank_states(self.bank, mesh)
                self._parallel_estep = pmesh.make_state_sharded_estep(
                    mesh, cfg.model.state_num, cfg.train.max_label_len,
                    normalizer=cfg.model.gaussian_normalizer,
                    count_final_exit=cfg.model.count_final_exit,
                    bw_inner_iters=cfg.model.bw_inner_iters,
                    score_dtype=cfg.model.score_dtype,
                )
            else:
                self._parallel_estep = pmesh.make_parallel_estep(
                    mesh, cfg.model.state_num, cfg.train.max_label_len,
                    normalizer=cfg.model.gaussian_normalizer,
                    count_final_exit=cfg.model.count_final_exit,
                    bw_inner_iters=cfg.model.bw_inner_iters,
                    score_dtype=cfg.model.score_dtype,
                )
                self.bank = pmesh.replicate_bank(self.bank, mesh)

    def export_bank(self):
        """The bank with state-shard padding stripped (for checkpointing
        / decoding)."""
        if self.bank.num_states == self._s_orig:
            return self.bank
        from poccala_tpu.parallel import mesh as pmesh

        return pmesh.unpad_bank_states(self.bank, self._s_orig)

    # ------------------------------------------------------------------
    def _next_key(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def _sharded_align(self):
        """Cached state-sharded forced-alignment program."""
        if getattr(self, "_sharded_align_fn", None) is None:
            from poccala_tpu.parallel import mesh as pmesh

            self._sharded_align_fn = pmesh.make_state_sharded_align(
                self.mesh, self.cfg.model.state_num,
                self.cfg.train.max_label_len,
                normalizer=self.cfg.model.gaussian_normalizer,
                score_dtype=self.cfg.model.score_dtype,
            )
        return self._sharded_align_fn

    def _sharded_fit(self, reinit: bool):
        """Cached state-sharded grouped k-means/EM program (keyed by
        mixture level and reinit flag)."""
        cache = getattr(self, "_sharded_fit_cache", None)
        if cache is None:
            cache = self._sharded_fit_cache = {}
        key = (self.mix_level, bool(reinit))
        if key not in cache:
            from poccala_tpu.parallel import mesh as pmesh

            cache[key] = pmesh.make_state_sharded_fit(
                self.mesh, self.mix_level, self.bank.max_mix, bool(reinit),
                c_covariance=self.var_floor,
                converge_delta=self.cfg.train.gmm_converge_delta,
                max_iters=self.cfg.train.max_em_iters,
                normalizer=self.cfg.model.gaussian_normalizer,
            )
        return cache[key]

    @property
    def var_floor(self):
        """Effective covariance floor for every EM/SMEM update: the
        reference's scalar ``c_covariance`` (default), or the per-dim
        relative floor once :meth:`_ensure_var_floor` has seen data
        (``ModelConfig.var_floor_scale``)."""
        if self._var_floor_vec is not None:
            return self._var_floor_vec
        return self.cfg.model.c_covariance

    def _ensure_var_floor(self, batches: Sequence[Batch]) -> None:
        """Compute the relative floor from the corpus (flat-start
        subsample rule: ``proportion`` of utterances, every ``step``-th
        frame) the first time training sees data.  No-op when the flag
        is off or the floor is already set."""
        if self.cfg.model.var_floor_scale <= 0 or \
                self._var_floor_vec is not None:
            return
        tcfg = self.cfg.train
        n_take = max(1, int(len(batches) * tcfg.proportion))
        frames = [b.feats[b.t_masks][:: tcfg.step]
                  for b in batches[:n_take]]
        x = np.concatenate(frames, axis=0)
        gv = np.maximum(x.var(axis=0), 1e-8)
        self._var_floor_vec = np.maximum(
            self.cfg.model.var_floor_scale * gv,
            self.cfg.model.c_covariance).astype(np.float32)
        self.log.info(
            "relative variance floor: scale=%g, floor range [%.3g, %.3g]",
            self.cfg.model.var_floor_scale,
            float(self._var_floor_vec.min()),
            float(self._var_floor_vec.max()))

    @property
    def state_num(self) -> int:
        return self.cfg.model.state_num

    @property
    def emit_states(self) -> int:
        return self.state_num - 2

    # ------------------------------------------------------------------
    # Flat start (scheme 2 init)
    # ------------------------------------------------------------------

    def flat_start(self, batches: Sequence[Batch]) -> None:
        """Global mean/variance from a data subsample, broadcast to every
        senone (``__flat_start``, ``AcousticModel.py:479-517``):
        ``proportion`` of utterances, every ``step``-th frame."""
        tcfg = self.cfg.train
        n_take = max(1, int(len(batches) * tcfg.proportion))
        frames = []
        for batch in batches[:n_take]:
            f = batch.feats[batch.t_masks]
            frames.append(f[:: tcfg.step])
        x = np.concatenate(frames, axis=0)
        mean = jnp.asarray(x.mean(axis=0))
        var = jnp.asarray(np.maximum(x.var(axis=0), 1e-4))
        self.bank = sb.flat_start(
            self.bank, mean, var, self._next_key(),
            coefficient=tcfg.coefficient,
            differentiation=tcfg.differentiation,
        )
        self.log.info("flat start: %d frames -> global mean/cov", len(x))

    # ------------------------------------------------------------------
    # Scheme 2: embedded Baum-Welch epoch
    # ------------------------------------------------------------------

    def scheme2_epoch(self, batches: Iterable[Batch],
                      update_gmm: bool = True,
                      update_transmat: bool = True) -> float:
        """One full embedded-BW EM step over the corpus
        (``embedded_training``, ``AcousticModel.py:842-882``)."""
        if isinstance(batches, Sequence):
            self._ensure_var_floor(batches)
        elif (self.cfg.model.var_floor_scale > 0
              and self._var_floor_vec is None):
            self.log.warning(
                "var_floor_scale set but batches is a generator; "
                "relative floor not computable here — still using the "
                "scalar c_covariance floor (pass a materialized batch "
                "list, or call _ensure_var_floor first)")
        total = acc.zero_stats(self.bank)
        for batch in batches:
            if self._parallel_estep is not None:
                from poccala_tpu.parallel import pad_batch_for_mesh

                arrays, _ = pad_batch_for_mesh(
                    (batch.labels, batch.label_lens, batch.feats,
                     batch.t_masks), self.mesh,
                )
                stats, _ = self._parallel_estep(
                    self.bank, *(jnp.asarray(a) for a in arrays)
                )
            else:
                stats, _ = acc.batch_stats(
                    self.bank,
                    jnp.asarray(batch.labels), jnp.asarray(batch.label_lens),
                    jnp.asarray(batch.feats), jnp.asarray(batch.t_masks),
                    self.state_num, self.cfg.train.max_label_len,
                    normalizer=self.cfg.model.gaussian_normalizer,
                    count_final_exit=self.cfg.model.count_final_exit,
                    bw_inner_iters=self.cfg.model.bw_inner_iters,
                    score_dtype=self.cfg.model.score_dtype,
                )
            total = acc.add_stats(total, stats)
        self.bank = acc.apply_update(
            self.bank, total,
            c_covariance=self.var_floor,
            update_transmat=update_transmat,
            update_gmm=update_gmm,
        )
        ll = float(total.loglik)
        n = max(float(total.n_utts), 1.0)
        self.log.info(
            "embedded BW epoch: loglik=%.2f (%.2f/utt over %d utts)",
            ll, ll / n, int(n),
        )
        return ll

    # ------------------------------------------------------------------
    # Scheme 1: segmentation / alignment + per-senone GMM training
    # ------------------------------------------------------------------

    def _collect_frames(self, batches: Sequence[Batch], init: bool):
        """Per-senone frame buckets from uniform segmentation (init) or
        Viterbi alignment (re-estimation)."""
        num_senones = self.bank.num_states
        all_x, all_labels, all_lens, all_pos, all_ok = [], [], [], [], []
        for batch in batches:
            if init:
                label_pos = align.uniform_label_pos(
                    batch.label_lens, batch.t_masks
                )
                ok = np.ones(len(batch.feats), bool)
            else:
                if self.state_shards > 1:
                    # bank stays sharded P('state'); full-S GMM tensors
                    # never materialize (pmax'd score lattices instead)
                    from poccala_tpu.parallel import pad_batch_for_mesh

                    arrays, b_true = pad_batch_for_mesh(
                        (batch.labels, batch.label_lens, batch.feats,
                         batch.t_masks), self.mesh,
                    )
                    _, lp = self._sharded_align()(
                        self.bank, *(jnp.asarray(a) for a in arrays)
                    )
                    label_pos = np.asarray(lp)[:b_true]
                else:
                    _, lp = align.align_batch(
                        self.bank,
                        jnp.asarray(batch.labels),
                        jnp.asarray(batch.label_lens),
                        jnp.asarray(batch.feats), jnp.asarray(batch.t_masks),
                        self.state_num, self.cfg.train.max_label_len,
                        normalizer=self.cfg.model.gaussian_normalizer,
                        score_dtype=self.cfg.model.score_dtype,
                    )
                    label_pos = np.asarray(lp)
                ok = align.check_alignment(
                    label_pos, batch.labels, batch.label_lens
                )
                if not ok.all():
                    self.log.warning(
                        "viterbi alignment failed for %d/%d utterances "
                        "(discarded)", int((~ok).sum()), len(ok),
                    )
            all_x.append(batch.feats)
            all_labels.append(batch.labels)
            all_lens.append(batch.label_lens)
            all_pos.append(label_pos)
            all_ok.append(ok)

        # bucket capacity: generous share of the total frame budget
        total_frames = sum(int(b.t_masks.sum()) for b in batches)
        cap = max(256, min(8192, 4 * total_frames // max(num_senones, 1)))
        xs = np.concatenate(all_x)
        frames, mask, dropped = align.group_frames_by_senone(
            xs, np.concatenate(all_labels), np.concatenate(all_lens),
            np.concatenate(all_pos), num_senones, self.emit_states,
            max_frames_per_senone=cap,
            utt_ok=np.concatenate(all_ok),
            rng=np.random.default_rng(int(self._next_key()[0])),
            senone_map=np.asarray(self.bank.senone_map),
        )
        if dropped:
            self.log.warning(
                "senone frame buckets overflowed: %d frames subsampled away "
                "(cap=%d)", dropped, cap,
            )
        return frames, mask

    def fit_gmms(self, frames: np.ndarray, mask: np.ndarray,
                 reinit: bool, smem: bool = False) -> None:
        """k-means (re)init + grouped EM over all senones
        (``__cal_gmm``, ``AcousticModel.py:532-561``).

        Senones with fewer frames than the mixture count keep their old
        parameters (``AcousticModel.py:549-551``)."""
        mix = self.mix_level
        bank = self.bank
        if self.state_shards > 1:
            # per-senone-independent program sharded over the state axis:
            # each shard k-means/EM-fits its local senones' GMMs; no
            # device ever holds the full-S tensors (scheme 1 at
            # BASELINE config-4 scale, Controller.py:47-77)
            fit = self._sharded_fit(reinit)
            new_means, new_lv, new_lw, new_mc = fit(
                self._next_key(), jnp.asarray(frames), jnp.asarray(mask),
                bank.means, bank.log_var, bank.log_w, bank.mix_counts,
            )
            self.bank = dataclasses.replace(
                bank, means=new_means, log_var=new_lv, log_w=new_lw,
                mix_counts=new_mc,
            )
            if smem:
                from poccala_tpu.train.smem import smem_pass

                self.bank, n_accepted = smem_pass(
                    self, frames, mask,
                    np.asarray(mask.sum(axis=1) >= max(mix, 2)),
                )
                if n_accepted:
                    self.log.info("SMEM: %d split-merge moves accepted",
                                  n_accepted)
            return
        counts = mask.sum(axis=1)
        enough = jnp.asarray(counts >= max(mix, 2))
        frames_j = jnp.asarray(frames)
        mask_j = jnp.asarray(mask)

        means = bank.means[:, : bank.max_mix]
        log_var = bank.log_var
        log_w = bank.log_w

        if reinit:
            kres = km_ops.kmeans_grouped(
                self._next_key(), frames_j, mask_j, k=mix
            )
            pad = bank.max_mix - mix
            km_means = jnp.pad(kres["means"], ((0, 0), (0, pad), (0, 0)))
            km_logvar = jnp.pad(
                jnp.log(kres["variances"]), ((0, 0), (0, pad), (0, 0))
            )
            km_logw = masked_log(jnp.pad(kres["alpha"], ((0, 0), (0, pad))))
            sel = enough[:, None, None]
            means = jnp.where(sel, km_means, means)
            log_var = jnp.where(sel, km_logvar, log_var)
            log_w = jnp.where(enough[:, None], km_logw, log_w)

        mix_mask = jnp.arange(bank.max_mix)[None, :] < mix
        mix_mask = jnp.tile(mix_mask, (bank.num_states, 1))
        params, q, iters = em_ops.em_fit_grouped(
            means, log_var, log_w,
            frames_j, mask_j, mix_mask,
            c_covariance=self.var_floor,
            converge_delta=self.cfg.train.gmm_converge_delta,
            max_iters=self.cfg.train.max_em_iters,
            normalizer=self.cfg.model.gaussian_normalizer,
        )
        sel = enough[:, None, None]
        self.bank = dataclasses.replace(
            bank,
            means=jnp.where(sel, params.means, bank.means),
            log_var=jnp.where(sel, params.log_var, bank.log_var),
            log_w=jnp.where(enough[:, None], params.log_w, bank.log_w),
            mix_counts=jnp.where(
                enough, mix, bank.mix_counts
            ).astype(jnp.int32),
        )
        if smem:
            from poccala_tpu.train.smem import smem_pass

            self.bank, n_accepted = smem_pass(
                self, frames, mask, np.asarray(enough)
            )
            if n_accepted:
                self.log.info("SMEM: %d split-merge moves accepted", n_accepted)

    def scheme1_round(self, batches: Sequence[Batch], init: bool,
                      smem: bool | None = None,
                      reinit: bool | None = None) -> float:
        """One scheme-1 round: (re)segment → GMM training → embedded
        transmat re-estimation (``Task.auto`` mode-1 body,
        ``Controller.py:190-196``).

        ``reinit``: force (True) or forbid (False) the k-means
        re-seeding of the GMMs; ``None`` (default) auto-detects from
        mixture growth as the reference does
        (``AcousticModel.py:552-558``).  The CD retrain path passes
        False — its leaves are clones of their CI parents and MAP
        smoothing's slot-wise blending requires the EM refit to start
        FROM the clone (component correspondence), which a re-seed
        would silently break whenever any cloned senone's mix_counts
        differ from mix_level (e.g. starved CI senones)."""
        self._ensure_var_floor(batches)
        if reinit is None:
            reinit = init or bool(
                np.any(np.asarray(self.bank.mix_counts) != self.mix_level)
            )
        frames, mask = self._collect_frames(batches, init=init)
        if smem is None:
            smem = init and self.cfg.train.smem
        self.fit_gmms(frames, mask, reinit=reinit, smem=smem)
        # embedded training with GMMs locked (fix_code=2)
        return self.scheme2_epoch(batches, update_gmm=False)

    # ------------------------------------------------------------------
    # Mixture growth (Controller.add_mix_level, Controller.py:153-159)
    # ------------------------------------------------------------------

    def add_mix_level(self) -> None:
        if self.mix_level < self.cfg.model.max_mix_level:
            self.mix_level += 1
            self.log.info("mixture level -> %d", self.mix_level)

    # ------------------------------------------------------------------
    # Auto loop (Task.auto, Controller.py:161-202)
    # ------------------------------------------------------------------

    def auto(self, batches: Sequence[Batch], t: int = 1, mode: int = 1,
             init: bool = True, add_mix: bool = False) -> list[float]:
        logliks = []
        self._ensure_var_floor(batches)
        for round_idx in range(t):
            t0 = time.time()
            if mode == 1:
                ll = self.scheme1_round(batches, init=init)
            elif mode == 2:
                if init:
                    self.flat_start(batches)
                ll = self.scheme2_epoch(batches)
            else:
                raise ModeError(f"unknown training scheme: {mode}")
            logliks.append(ll)
            self.history.append({
                "mode": mode, "round": round_idx, "loglik": ll,
                "mix_level": self.mix_level, "seconds": time.time() - t0,
            })
            if add_mix and mode == 1:
                self.add_mix_level()
            init = False
        return logliks
