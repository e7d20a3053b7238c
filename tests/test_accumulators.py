"""Baum-Welch accumulator tests: oracle parity + EM monotonicity."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from poccala_tpu.config import ModelConfig
from poccala_tpu.models import senone_bank as sb
from poccala_tpu.train import accumulators as acc
from poccala_tpu.utils.logmath import masked_log

from . import oracles
from .test_senone_topology import make_bank


def oracle_stats(bank, label, x, state_num):
    """NumPy oracle: γ/ξ from the dense embedded model, scattered by hand.

    Mirrors LHMM.__maximization + update_acc (LHMM.py:426-507) with
    P(O)-normalization (see accumulators.py docstring)."""
    emit = state_num - 2
    s_total, m_mix, d = np.asarray(bank.means).shape
    u_total = np.asarray(bank.log_A).shape[0]
    t = x.shape[0]

    # dense embedded model via the reference-construction oracle
    A_np = np.exp(np.asarray(bank.log_A))
    A_np[A_np < 1e-20] = 0.0
    unit_A = [A_np[u] for u in label]

    # per-state component log-probs
    means = np.asarray(bank.means, np.float64)
    log_var = np.asarray(bank.log_var, np.float64)
    log_w = np.asarray(bank.log_w, np.float64)

    def comp_logpdf(s):
        out = np.zeros((t, m_mix))
        for mi in range(m_mix):
            diff = x - means[s, mi]
            out[:, mi] = (
                -0.5 * d * np.log(2 * np.pi)
                - 0.5 * log_var[s, mi].sum()
                - 0.5 * (diff * diff / np.exp(log_var[s, mi])).sum(-1)
            ) + log_w[s, mi]
        return out

    sen_rows = []
    for u in label:
        for e in range(emit):
            sen_rows.append(u * emit + e)
    comp = np.stack([comp_logpdf(s) for s in sen_rows], axis=1)  # [T, Ne, M]
    scores = oracles.np_logsumexp(comp, axis=-1)                 # [T, Ne]
    unit_scores = [
        scores[:, i * emit:(i + 1) * emit].T for i in range(len(label))
    ]
    Ad, prob, pi = oracles.embedded_oracle(unit_A, unit_scores, state_num)
    with np.errstate(divide="ignore"):
        logAd = np.log(Ad)
        logpi = np.log(pi)
    la = oracles.forward_oracle(logAd, logpi, prob)   # [Ns, T]
    lb = oracles.backward_oracle(logAd, prob)
    loglik = oracles.np_logsumexp(la[:, -1])

    gamma = np.exp(la + lb - loglik)                  # [Ns, T]
    n_s = Ad.shape[0]
    ksai = np.zeros((n_s, n_s))
    for ti in range(t - 1):
        lg = (
            la[:, ti][:, None] + logAd + prob[:, ti + 1][None, :]
            + lb[:, ti + 1][None, :] - loglik
        )
        ksai += np.where(np.isfinite(lg), np.exp(np.where(np.isfinite(lg), lg, 0)), 0.0)

    # scatter
    occ = np.zeros(s_total)
    c = np.zeros((s_total, m_mix))
    cx = np.zeros((s_total, m_mix, d))
    cxx = np.zeros((s_total, m_mix, d))
    trans = np.zeros((u_total, state_num, state_num))
    trans_den = np.zeros((u_total, state_num))
    for r in range(1, n_s - 1):
        i = (r - 1) // emit
        local = (r - 1) % emit + 1
        u = label[i]
        s = sen_rows[r - 1]
        occ[s] += gamma[r].sum()
        post = np.exp(comp[:, r - 1, :] - scores[:, r - 1][:, None])
        grm = gamma[r][:, None] * post
        c[s] += grm.sum(0)
        cx[s] += grm.T @ x
        cxx[s] += grm.T @ (x * x)
        trans_den[u, local] += gamma[r, :-1].sum()
        for k in range(state_num):
            col = r + k
            lc = local + k
            if col < n_s and lc < state_num:
                trans[u, local, lc] += ksai[r, col]
    return dict(occ=occ, c=c, cx=cx, cxx=cxx, trans=trans,
                trans_den=trans_den, loglik=loglik,
                # the dense sentence model, for alignment oracles
                scores=scores, A=Ad, prob=prob, pi=pi)


class TestUtteranceStats:
    def test_matches_oracle(self, rng):
        cfg, bank = make_bank(rng, num_units=3, state_num=5, mix=2, max_mix=2, dim=5)
        label = [1, 0, 1]
        t, max_l = 18, 4
        x = rng.normal(size=(t, 5)).astype(np.float32)
        label_pad = np.zeros(max_l, np.int32)
        label_pad[:3] = label
        stats, ll = acc.utterance_stats(
            bank, jnp.asarray(label_pad), jnp.asarray(3), jnp.asarray(x),
            jnp.ones(t, bool), cfg.state_num, max_l,
            count_final_exit=False,  # oracle replicates the reference
        )
        want = oracle_stats(bank, label, np.asarray(x, np.float64), cfg.state_num)
        assert np.allclose(float(ll), want["loglik"], rtol=1e-4)
        for name in ("occ", "c", "cx", "cxx", "trans", "trans_den"):
            got = np.asarray(getattr(stats, name))
            assert np.allclose(got, want[name], rtol=2e-3, atol=2e-3), name

    def test_padding_invariance(self, rng):
        cfg, bank = make_bank(rng, num_units=3, state_num=5, mix=2, max_mix=2, dim=5)
        label_pad = jnp.asarray([2, 1, 0, 0], dtype=jnp.int32)
        t_true, t_pad = 15, 24
        x = rng.normal(size=(t_pad, 5)).astype(np.float32)
        mask = np.arange(t_pad) < t_true
        s1, ll1 = acc.utterance_stats(
            bank, label_pad, jnp.asarray(2), jnp.asarray(x[:t_true]),
            jnp.ones(t_true, bool), cfg.state_num, 4,
        )
        s2, ll2 = acc.utterance_stats(
            bank, label_pad, jnp.asarray(2), jnp.asarray(x),
            jnp.asarray(mask), cfg.state_num, 4,
        )
        assert np.allclose(float(ll1), float(ll2), rtol=1e-5)
        for name in ("occ", "c", "cx", "cxx", "trans", "trans_den"):
            assert np.allclose(
                np.asarray(getattr(s1, name)), np.asarray(getattr(s2, name)),
                rtol=1e-4, atol=1e-4,
            ), name


class TestBaumWelchStep:
    def synth_batch(self, rng, bank, cfg, b=6, t=30, max_l=3):
        """Sample synthetic utterances roughly following the bank."""
        labels = rng.integers(0, bank.num_units, size=(b, max_l)).astype(np.int32)
        lens = rng.integers(1, max_l + 1, size=(b,)).astype(np.int32)
        d = bank.dim
        xs = np.zeros((b, t, d), np.float32)
        for i in range(b):
            # simple synthetic: frames drawn near the label's senone means
            units = labels[i, : lens[i]]
            seq = np.repeat(units, t // max(len(units), 1) + 1)[:t]
            for ti, u in enumerate(seq):
                s = u * cfg.emit_states + rng.integers(0, cfg.emit_states)
                m = rng.integers(0, 2)
                xs[i, ti] = np.asarray(bank.means)[s, m] + rng.normal(size=d) * 0.5
        masks = np.ones((b, t), bool)
        return (jnp.asarray(labels), jnp.asarray(lens), jnp.asarray(xs),
                jnp.asarray(masks))

    def test_loglik_improves(self, rng):
        """Full E+M steps must increase total data log-likelihood (EM
        monotonicity) — the batched analog of baulm_welch's iterate-until-
        converged loop (LHMM.py:526-544)."""
        cfg, bank = make_bank(rng, num_units=3, state_num=5, mix=2, max_mix=2, dim=5)
        batch = self.synth_batch(rng, bank, cfg)
        lls = []
        for _ in range(4):
            stats, logliks = acc.batch_stats(
                bank, *batch, cfg.state_num, 3
            )
            lls.append(float(stats.loglik))
            bank = acc.apply_update(bank, stats)
        assert lls[1] > lls[0]
        assert lls[3] >= lls[2] - 1e-3
        # transition rows remain stochastic
        a = np.exp(np.asarray(bank.log_A))
        rowsums = a[:, 1:-1, :].sum(-1)
        assert np.allclose(rowsums, 1.0, atol=1e-3)
        # weights stay normalized
        w = np.exp(np.asarray(bank.log_w)).sum(-1)
        assert np.allclose(w, 1.0, atol=1e-3)

    def test_fix_code_freezes(self, rng):
        """fix_code=2 locks the GMMs (scheme 1 embedded training,
        AcousticModel.py:705, 789; LHMM.py:140-146)."""
        cfg, bank = make_bank(rng, num_units=3, state_num=5, mix=2, max_mix=2, dim=5)
        batch = self.synth_batch(rng, bank, cfg)
        stats, _ = acc.batch_stats(bank, *batch, cfg.state_num, 3)
        b2 = acc.apply_update(bank, stats, update_gmm=False)
        assert np.array_equal(np.asarray(b2.means), np.asarray(bank.means))
        assert not np.array_equal(np.asarray(b2.log_A), np.asarray(bank.log_A))
        b3 = acc.apply_update(bank, stats, update_transmat=False)
        assert np.array_equal(np.asarray(b3.log_A), np.asarray(bank.log_A))


class TestInnerBwLoop:
    def test_inner_pi_iterations_improve_loglik(self, rng):
        """bw_inner_iters reproduces the reference's per-utterance
        baulm_welch pi refinement (LHMM.py:526-544): the converged
        likelihood must be >= the single-pass one."""
        cfg, bank = make_bank(rng, num_units=3, state_num=5, mix=2,
                              max_mix=2, dim=5)
        label = jnp.asarray([1, 0, 2, 0], dtype=jnp.int32)
        t = 24
        x = jnp.asarray(rng.normal(size=(t, 5)).astype(np.float32))
        mask = jnp.ones(t, bool)
        s1, ll1 = acc.utterance_stats(
            bank, label, jnp.asarray(3), x, mask, cfg.state_num, 4,
            bw_inner_iters=1,
        )
        s2, ll2 = acc.utterance_stats(
            bank, label, jnp.asarray(3), x, mask, cfg.state_num, 4,
            bw_inner_iters=8,
        )
        assert float(ll2) >= float(ll1) - 1e-4
        # statistics remain finite and occupancy mass is preserved-ish
        assert np.isfinite(np.asarray(s2.occ)).all()
        assert float(s2.occ.sum()) > 0
