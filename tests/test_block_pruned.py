"""Block-pruned device decode (``active_blocks``): permutation/padding
invariants, exact-vs-pruned agreement, and config plumbing.

The pruned search is the block form of the reference's beam pruning
(``/root/reference/Decoder.py:34,159-167`` — keep-fraction beam over
live tokens): per frame only the K best-scoring blocks of DFS-contiguous
nodes run the banded advance.  These tests pin (a) the device-table
permutation invariants against an independent oracle, (b) 1-best
agreement with the exact dense search on clean utterances, and (c) the
measured agreement rate on hard (noisy) utterances, so the accuracy cost
of the approximation is a tested number, not a claim."""

import dataclasses
import os

import numpy as np
import pytest

from poccala_tpu.config import Config, ModelConfig
from poccala_tpu.io.corpus import UnitInventory
from poccala_tpu.lexicon.build import DEFAULT_DAT, build_reference_lexicon

pytestmark = pytest.mark.skipif(
    not os.path.exists(DEFAULT_DAT), reason="reference Mandarin.dat absent"
)


@pytest.fixture(scope="module")
def world():
    """A mid-size lexicon (hundreds of nodes, >> block_size) with a
    separable random bank — big enough that block pruning is real
    (many blocks), small enough for CPU."""
    import jax.numpy as jnp

    from poccala_tpu.models import senone_bank as sb

    rng = np.random.default_rng(11)
    inv = UnitInventory.standard("XIF_tone")
    flat, words, py = build_reference_lexicon(
        inv, n_single=420, n_multi=160)
    d = 8
    cfg = ModelConfig(state_num=5, mix_level=1, max_mix_level=1)
    bank = sb.create_bank(len(inv), cfg, d, differentiation=False)
    emb = rng.normal(size=(len(inv), d)).astype(np.float32) * 4
    means = np.repeat(emb, cfg.state_num - 2, axis=0)[:, None, :]
    bank = dataclasses.replace(bank, means=jnp.asarray(means))
    return inv, flat, words, py, bank, emb


def _decodable(words, py, inv, n, rng, max_syllables=2):
    """Sample words whose first reading lies inside the inventory."""
    out = []
    order = rng.permutation(len(words))
    for i in order:
        w = words[i]
        us = py.units_of(w)
        if us is None or len(us) > max_syllables:
            continue
        units = [u for ch in us for u in ch[0]]
        if all(u in inv.id_of for u in units):
            out.append((w, [inv.id_of[u] for u in units]))
        if len(out) >= n:
            break
    return out


def _feats(emb, unit_ids, rng, fp=8, noise=0.3):
    xs = [emb[u] + rng.normal(size=(fp, emb.shape[1])) * noise
          for u in unit_ids]
    return np.concatenate(xs).astype(np.float32)


class TestPruneInvariants:
    def test_permutation_and_padding(self, world):
        """Oracle check of the DFS permutation + padding: bijectivity,
        preorder subtree contiguity, parent remapping, dead pad rows."""
        from poccala_tpu.decoder.device import DeviceBeamDecoder
        from poccala_tpu.utils.logmath import NEG_INF

        inv, flat, words, py, bank, emb = world
        dec = DeviceBeamDecoder(bank, flat, block_size=64, active_blocks=2)
        dec._prep_device()
        assert dec._prune_on, "pruning must engage at this scale"
        n_nodes = flat.n_nodes
        perm = dec._perm
        # bijection over the real nodes, rooted at node 0
        assert perm is not None and len(perm) == n_nodes
        assert sorted(perm) == list(range(n_nodes))
        assert perm[0] == 0

        # independent DFS oracle: preorder positions + subtree sizes
        new_of = np.empty(n_nodes, np.int64)
        new_of[perm] = np.arange(n_nodes)

        def subtree_size(nid):
            return 1 + sum(subtree_size(c) for c in flat.children(nid))

        # every subtree occupies a contiguous index range in the new
        # order (the property the block scheme relies on: a live word
        # keeps its prefix path in few blocks)
        for nid in range(1, n_nodes, max(1, n_nodes // 40)):
            size = subtree_size(nid)
            lo = new_of[nid]
            ids = []

            def collect(m):
                ids.append(new_of[m])
                for c in flat.children(m):
                    collect(c)

            collect(nid)
            assert min(ids) == lo and max(ids) == lo + size - 1

        # parent table remapped consistently (old parent -> new index);
        # root children have parent -1 (entry via word re-entry only)
        par_old = np.full(n_nodes, -1, np.int64)
        for p in range(1, n_nodes):
            for c in flat.children(p):
                par_old[c] = p
        par_dev = np.asarray(dec._j_parent)
        for i in range(0, n_nodes, max(1, n_nodes // 100)):
            old = perm[i]
            expect = -1 if par_old[old] < 0 else new_of[par_old[old]]
            assert par_dev[i] == expect, (i, old)

        # padding: total length a block multiple; pad rows fully dead
        n_pad = np.asarray(dec._j_senone).shape[0]
        assert n_pad % dec.block_size == 0 and n_pad >= n_nodes
        if n_pad > n_nodes:
            assert np.all(np.asarray(dec._j_senone)[n_nodes:] == -1)
            assert np.all(np.asarray(dec._j_word)[n_nodes:] == -1)
            assert np.all(par_dev[n_nodes:] == -1)
            assert np.all(np.asarray(dec._j_bands)[n_nodes:] <= NEG_INF / 2)
            assert not np.asarray(dec._j_is_root_child)[n_nodes:].any()

    def test_noop_below_block_count(self, world):
        """active_blocks >= n_blocks must fall back to the exact search
        (pruning would be a no-op)."""
        from poccala_tpu.decoder.device import DeviceBeamDecoder

        inv, flat, words, py, bank, emb = world
        dec = DeviceBeamDecoder(bank, flat, block_size=4096,
                                active_blocks=8)
        dec._prep_device()
        assert not dec._prune_on


class TestPrunedAgreement:
    def test_clean_one_best_matches_exact(self, world):
        """On separable utterances the pruned search must return the
        exact search's 1-best, scores included."""
        from poccala_tpu.decoder.device import DeviceBeamDecoder

        inv, flat, words, py, bank, emb = world
        rng = np.random.default_rng(5)
        chosen = _decodable(words, py, inv, 8, rng)
        assert len(chosen) >= 6
        exact = DeviceBeamDecoder(bank, flat)
        pruned = DeviceBeamDecoder(bank, flat, block_size=64,
                                   active_blocks=2)
        for w, uids in chosen:
            x = _feats(emb, uids, rng)
            h_ex = exact.decode(x)
            h_pr = pruned.decode(x)
            assert pruned._prune_on
            assert h_ex and h_pr, w
            assert h_pr[0].words == h_ex[0].words, (w, h_pr[0].words)
            assert np.isclose(h_pr[0].score, h_ex[0].score, rtol=1e-4), w

    def test_noisy_agreement_rate(self, world):
        """Measured accuracy cost of the approximation on hard inputs:
        batch-decode noisy utterances exact vs pruned and bound the
        1-best disagreement rate.  Pruned scores can never exceed the
        exact Viterbi scores (the pruned search explores a subset of
        paths)."""
        from poccala_tpu.decoder.device import DeviceBeamDecoder
        from poccala_tpu.utils.logmath import NEG_INF

        inv, flat, words, py, bank, emb = world
        rng = np.random.default_rng(9)
        chosen = _decodable(words, py, inv, 24, rng)
        t_pad = 24
        feats = np.zeros((len(chosen), t_pad, emb.shape[1]), np.float32)
        nf = np.zeros(len(chosen), np.int32)
        for i, (_, uids) in enumerate(chosen):
            x = _feats(emb, uids, rng, noise=0.8)[:t_pad]
            feats[i, : len(x)] = x
            nf[i] = len(x)
        exact = DeviceBeamDecoder(bank, flat)
        pruned = DeviceBeamDecoder(bank, flat, block_size=64,
                                   active_blocks=3)
        out_ex = exact.decode_batch(feats, nf)
        out_pr = pruned.decode_batch(feats, nf)
        agree = 0
        for he, hp in zip(out_ex, out_pr):
            assert he and hp
            agree += he[0].words == hp[0].words
            assert hp[0].score <= he[0].score + 1e-3
        # at 3/~11 active blocks on noise-0.8 inputs the pruned 1-best
        # tracks the exact one on the large majority of utterances
        assert agree >= int(0.75 * len(chosen)), (agree, len(chosen))

    def test_hysteresis_still_agrees_on_clean(self, world):
        """Sticky selection (prune_hysteresis) changes only WHICH
        blocks stay active; on separable inputs the 1-best must still
        match the exact search, and pruned scores stay <= exact.  On
        noisy inputs stickiness must not do worse than the exact score
        bound either."""
        from poccala_tpu.decoder.device import DeviceBeamDecoder

        inv, flat, words, py, bank, emb = world
        rng = np.random.default_rng(21)
        chosen = _decodable(words, py, inv, 8, rng)
        exact = DeviceBeamDecoder(bank, flat)
        sticky = DeviceBeamDecoder(bank, flat, block_size=64,
                                   active_blocks=2,
                                   prune_hysteresis=4.0)
        assert sticky.prune_hysteresis == 4.0
        for w, uids in chosen[:6]:
            x = _feats(emb, uids, rng)
            h_ex = exact.decode(x)
            h_st = sticky.decode(x)
            assert h_ex and h_st, w
            assert h_st[0].words == h_ex[0].words, (w, h_st[0].words)
            assert h_st[0].score <= h_ex[0].score + 1e-3

    def test_hysteresis_reduces_selection_churn(self, world):
        """On hard (noisy) inputs the sticky selection must not lose to
        the thrash-prone default in 1-best agreement with exact — the
        property the knob exists for (WER_r05_cd.json fullvocab rows
        showed the trained-score collapse)."""
        from poccala_tpu.decoder.device import DeviceBeamDecoder

        inv, flat, words, py, bank, emb = world
        rng = np.random.default_rng(23)
        chosen = _decodable(words, py, inv, 24, rng)
        t_pad = 24
        feats = np.zeros((len(chosen), t_pad, emb.shape[1]), np.float32)
        nf = np.zeros(len(chosen), np.int32)
        for i, (_, uids) in enumerate(chosen):
            x = _feats(emb, uids, rng, noise=1.2)[:t_pad]
            feats[i, : len(x)] = x
            nf[i] = len(x)
        exact = DeviceBeamDecoder(bank, flat)
        plain = DeviceBeamDecoder(bank, flat, block_size=64,
                                  active_blocks=2)
        sticky = DeviceBeamDecoder(bank, flat, block_size=64,
                                   active_blocks=2,
                                   prune_hysteresis=6.0)
        out_ex = exact.decode_batch(feats, nf)
        out_pl = plain.decode_batch(feats, nf)
        out_st = sticky.decode_batch(feats, nf)
        def top(h):
            return h[0].words if h else None

        a_plain = sum(top(he) is not None and top(he) == top(hp)
                      for he, hp in zip(out_ex, out_pl))
        a_sticky = sum(top(he) is not None and top(he) == top(hs)
                       for he, hs in zip(out_ex, out_st))
        assert a_sticky >= a_plain - 2, (a_sticky, a_plain)

    def test_pruned_with_lm(self, world):
        """The word-boundary LM path (sparse bigram + re-entry ctx) is
        shared between exact and pruned steps; decode must agree on
        clean inputs with an LM attached."""
        from poccala_tpu.decoder.device import DeviceBeamDecoder
        from poccala_tpu.lm import Ngram

        inv, flat, words, py, bank, emb = world
        rng = np.random.default_rng(13)
        chosen = _decodable(words, py, inv, 6, rng, max_syllables=1)
        lm = Ngram(2)
        lm.train([[w] for w, _ in chosen] * 3)
        exact = DeviceBeamDecoder(bank, flat, lm=lm, lm_weight=4.0)
        pruned = DeviceBeamDecoder(bank, flat, lm=lm, lm_weight=4.0,
                                   block_size=64, active_blocks=2)
        for w, uids in chosen[:4]:
            x = _feats(emb, uids, rng)
            h_ex = exact.decode(x)
            h_pr = pruned.decode(x)
            assert h_ex and h_pr
            assert h_pr[0].words == h_ex[0].words, w
            assert np.isclose(h_pr[0].score, h_ex[0].score, rtol=1e-4)


class TestConfigPlumbing:
    def test_config_keys(self):
        cfg = Config()
        cfg.apply_overrides(["decoder.active_blocks=3",
                             "decoder.block_size=256"])
        assert cfg.decoder.active_blocks == 3
        assert cfg.decoder.block_size == 256

    def test_decoder_constructed_from_config(self, world):
        """The CLI wiring: cfg.decoder.* reaches the device decoder."""
        from poccala_tpu.decoder.device import DeviceBeamDecoder

        inv, flat, words, py, bank, emb = world
        cfg = Config()
        cfg.apply_overrides(["decoder.active_blocks=2",
                             "decoder.block_size=64"])
        dec = DeviceBeamDecoder(
            bank, flat, block_size=cfg.decoder.block_size,
            active_blocks=cfg.decoder.active_blocks or None)
        dec._prep_device()
        assert dec._prune_on and dec.active_blocks == 2
