"""bf16 GMM-scoring accuracy budget (``model.score_dtype``).

ROADMAP item "bf16 scoring option": bf16 operands run the scoring matmuls
on the tensor cores and halve the bank's parameter-side traffic, but the
8-bit mantissa must not disturb training or decoding.  These tests pin
the documented accuracy budget on CPU (the arithmetic is the same
bf16-operand / fp32-accumulate contraction XLA emits on the GPU):

* state-score drift vs fp32 under 0.1 nat mean / 0.5 nat max on
  MFCC-scale inputs (the shift-invariant centering in
  ``ops/gmm_score.py`` is what makes this hold — c0/energy offsets
  otherwise cost ~1.7 nats mean, measured in
  ``test_centering_is_what_saves_it``);
* Viterbi forced-alignment path flip rate < 1e-3 frames on a trained
  bank over a synthetic corpus;
* embedded-BW EM still converges (monotone loglik) when the E-step
  scores in bf16.

Its speed on the H100 is not yet measured (ROADMAP Queue 1 item 4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from poccala_tpu.config import ModelConfig
from poccala_tpu.models import senone_bank as sb
from poccala_tpu.ops.gmm_score import gmm_log_scores
from poccala_tpu.train import accumulators as acc
from poccala_tpu.train import alignment as align


def mfcc_like_inputs(rng, s=30, m=4, d=39, t=200):
    """MFCC-scale test data: a large shared c0-style offset plus
    per-senone structure — the regime where naive bf16 x² loses ~1 nat
    and centered bf16 does not."""
    offset = np.zeros(d, np.float32)
    offset[0] = 60.0  # log-energy c0 sits far from zero
    centers = rng.normal(size=(s, 1, d)).astype(np.float32) * 3
    means = jnp.asarray(
        offset + centers + rng.normal(size=(s, m, d)).astype(np.float32)
    )
    log_var = jnp.asarray(
        rng.uniform(0.5, 2.5, size=(s, m, d)).astype(np.float32)
    )
    w = rng.uniform(0.1, 1, size=(s, m))
    w /= w.sum(1, keepdims=True)
    log_w = jnp.log(jnp.asarray(w.astype(np.float32)))
    which = rng.integers(0, s, size=t)
    x = jnp.asarray(
        offset
        + centers[which, 0]
        + rng.normal(size=(t, d)).astype(np.float32) * 2
    )
    return x, means, log_var, log_w


class TestBf16Scores:
    def test_xla_drift_under_budget(self, rng):
        x, means, log_var, log_w = mfcc_like_inputs(rng)
        f32 = np.asarray(gmm_log_scores(x, means, log_var, log_w))
        bf16 = np.asarray(
            gmm_log_scores(x, means, log_var, log_w, score_dtype="bfloat16")
        )
        drift = np.abs(bf16 - f32)
        assert drift.mean() < 0.1, drift.mean()
        assert drift.max() < 0.5, drift.max()

    def test_centering_is_what_saves_it(self, rng):
        """Sanity that the budget is earned, not vacuous: uncentered bf16
        on the same inputs (simulated by pre-casting x and the packed
        coefficients without the shift) drifts an order of magnitude
        more."""
        x, means, log_var, log_w = mfcc_like_inputs(rng)
        f32 = np.asarray(gmm_log_scores(x, means, log_var, log_w))
        s, m, d = means.shape
        prec = jnp.exp(-log_var)
        a1 = prec.reshape(s * m, d)
        a2 = (means * prec).reshape(s * m, d)
        mu2p = jnp.sum(means * means * prec, axis=-1)
        const = -0.5 * d * np.log(2 * np.pi) - 0.5 * jnp.sum(log_var, -1)
        quad = (
            jnp.dot((x * x).astype(jnp.bfloat16), a1.astype(jnp.bfloat16).T,
                    preferred_element_type=jnp.float32)
            - 2 * jnp.dot(x.astype(jnp.bfloat16), a2.astype(jnp.bfloat16).T,
                          preferred_element_type=jnp.float32)
        )
        comp = -0.5 * (quad.reshape(len(x), s, m) + mu2p[None]) + const[None]
        naive = np.asarray(jax.nn.logsumexp(comp + log_w[None], axis=-1))
        centered = np.asarray(
            gmm_log_scores(x, means, log_var, log_w, score_dtype="bfloat16")
        )
        naive_err = np.abs(naive - f32).mean()
        cent_err = np.abs(centered - f32).mean()
        assert cent_err < 0.1
        assert naive_err > 10 * cent_err, (naive_err, cent_err)


def _trained_world(rng, num_units=8, d=13, t=120, b=16, max_l=4):
    """A trained-by-construction bank + matching synthetic batch: unit
    means are separated embeddings, frames are noisy draws from the
    label sequence — alignment has a clear optimum, as on real trained
    models (random banks would measure tie-breaking, not accuracy)."""
    cfg = ModelConfig(state_num=5, mix_level=2, max_mix_level=2)
    bank = sb.create_bank(num_units, cfg, d, key=jax.random.PRNGKey(1))
    emb = rng.normal(size=(num_units, d)).astype(np.float32) * 4
    emb[:, 0] += 55.0  # c0-style offset
    means = np.repeat(emb, cfg.emit_states, axis=0)[:, None, :]
    means = np.concatenate(
        [means, means + rng.normal(size=means.shape).astype(np.float32)],
        axis=1,
    )
    bank = dataclasses.replace(bank, means=jnp.asarray(means))

    labels = rng.integers(0, num_units, size=(b, max_l)).astype(np.int32)
    lens = rng.integers(2, max_l + 1, size=(b,)).astype(np.int32)
    xs = np.zeros((b, t, d), np.float32)
    for i in range(b):
        per = t // lens[i]
        for j in range(lens[i]):
            seg = slice(j * per, t if j == lens[i] - 1 else (j + 1) * per)
            n = seg.stop - seg.start
            xs[i, seg] = emb[labels[i, j]] + rng.normal(size=(n, d)) * 1.5
    masks = np.ones((b, t), bool)
    return cfg, bank, (jnp.asarray(labels), jnp.asarray(lens),
                       jnp.asarray(xs), jnp.asarray(masks))


class TestBf16Training:
    def test_viterbi_path_flip_rate(self, rng):
        cfg, bank, (labels, lens, xs, masks) = _trained_world(rng)
        _, lp32 = align.align_batch(
            bank, labels, lens, xs, masks, cfg.state_num, labels.shape[1]
        )
        _, lp16 = align.align_batch(
            bank, labels, lens, xs, masks, cfg.state_num, labels.shape[1],
            score_dtype="bfloat16",
        )
        flips = np.mean(np.asarray(lp32) != np.asarray(lp16))
        assert flips < 1e-3, flips

    def test_em_converges_with_bf16_estep(self, rng):
        cfg, bank, (labels, lens, xs, masks) = _trained_world(rng)
        lls = []
        for _ in range(3):
            stats, _ = acc.batch_stats(
                bank, labels, lens, xs, masks, cfg.state_num,
                labels.shape[1], score_dtype="bfloat16",
            )
            bank = acc.apply_update(bank, stats)
            lls.append(float(stats.loglik))
        assert lls[1] > lls[0] and lls[2] >= lls[1] - 1e-3, lls

    def test_bf16_loglik_close_to_f32(self, rng):
        cfg, bank, (labels, lens, xs, masks) = _trained_world(rng)
        s32, _ = acc.batch_stats(
            bank, labels, lens, xs, masks, cfg.state_num, labels.shape[1]
        )
        s16, _ = acc.batch_stats(
            bank, labels, lens, xs, masks, cfg.state_num, labels.shape[1],
            score_dtype="bfloat16",
        )
        # per-frame loglik drift under 0.05 nat
        per_frame = abs(float(s16.loglik) - float(s32.loglik)) / float(
            s32.n_frames
        )
        assert per_frame < 0.05, per_frame
