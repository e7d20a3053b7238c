"""End-to-end WER evaluation on the formant-synthesized proxy corpus.

BASELINE.md's acceptance clause is "WER parity on a held-out Mandarin
set"; the reference's intended corpora are real recordings (data_24 /
THCHS-30, ``/root/reference/config.ini:16-22``).  **This environment
ships no speech corpus and has no network egress** (verified: no WAV
corpora on disk, THCHS-30 not obtainable), so this run substitutes the
most realistic obtainable proxy — the coarticulated formant synthesizer
of :mod:`poccala_tpu.io.synth_formant` — and labels every number
accordingly.  The pipeline is the real one end to end:

  Mandarin.dat vocabulary → formant-synthesized WAV corpus with
  THCHS-style ``.trn`` labels (hanzi line + toned-pinyin line) →
  ``label_format='pinyin'`` Corpus (MFCC+Δ+ΔΔ, VAD) → flat start →
  embedded Baum-Welch (scheme 2) → Viterbi realignment + per-senone GMM
  EM with mixture growth (scheme 1) → [optional] k-means state tying
  (BASELINE config 3) → bigram-LM beam decode of held-out utterances
  from unseen speakers → WER/SER,

plus per-utterance log-likelihood / Viterbi-path parity of the trained
sentence HMMs against the *executed reference implementation*
(``StatisticalModel/LHMM.py``), the ``tests/test_reference_parity.py``
machinery applied to real trained models.

Writes a JSON record (``--out``).  Run on the GPU:  ``python
benchmarks/wer_run.py``  (a CPU run works too, slower).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def build_vocab(n_words: int, seed: int, with_tone: bool = False,
                homophones: int = 0):
    """Pronunciation-unique vocabulary from the reference table.

    ``with_tone=False`` (MFCC-only runs): unique ignoring tone —
    homophones are unscorable without context, and MFCC features are
    largely pitch-blind, so tone-minimal pairs are unresolvable by
    construction (equally true of the reference's MFCC pipeline).
    ``with_tone=True`` (pitch-feature runs): unique including tone, so
    tone-minimal pairs ARE in the vocabulary and must be resolved by the
    F0 feature column.

    ``homophones > 0`` additionally appends up to that many words whose
    FULL TONED pronunciation exactly matches a selected word's —
    acoustically indistinguishable by construction (the Mandarin
    homophone problem: 25,569 hanzi over ~1.3k toned syllables,
    ``Lexicon/Mandarin.dat``), so only LM context can pick the hanzi.
    These exercise the homophone-sausage rescoring path
    (``decoder/rescore.py``)."""
    from poccala_tpu.lexicon.build import DEFAULT_DAT, reference_words

    words, py = reference_words(DEFAULT_DAT, n_single=6000, n_multi=4000,
                                seed=seed)
    seen, vocab = set(), []
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(words))
    for i in order:
        w = words[i]
        p = py.word2pinyin(w)
        if p is None:
            continue
        pron = (tuple(r[0] for r in p) if with_tone else
                tuple(r[0].rstrip("0123456789") for r in p))
        if pron in seen:
            continue
        seen.add(pron)
        vocab.append(w)
        if len(vocab) >= n_words:
            break
    if homophones > 0:
        have = set(vocab)
        toned_of = {}
        for w in vocab:
            p = py.word2pinyin(w)
            toned_of.setdefault(tuple(r[0] for r in p), w)
        extra = []
        for i in order:
            w = words[i]
            if w in have:
                continue
            p = py.word2pinyin(w)
            if p is None:
                continue
            if tuple(r[0] for r in p) in toned_of:
                extra.append(w)
                have.add(w)
            if len(extra) >= homophones:
                break
        vocab = vocab + extra
    return vocab, py


def densify_band(band: np.ndarray) -> np.ndarray:
    """Banded sentence transmat -> dense linear-domain [N, N] for the
    reference LHMM (which takes probabilities, not logs)."""
    n_s, w = band.shape
    a = np.full((n_s, n_s), -np.inf)
    for k in range(w):
        idx = np.arange(n_s - k)
        a[idx, idx + k] = band[idx, k]
    return np.exp(np.maximum(a, -700))


def parity_check(bank, batch, cfg, n_utts: int = 5):
    """Per-utterance log-lik + Viterbi-path parity: our scan kernels vs
    the executed reference LHMM on the trained sentence HMMs."""
    ref_root = "/root/reference"
    if not os.path.isdir(os.path.join(ref_root, "StatisticalModel")):
        return {"available": False}
    sys.path.insert(0, ref_root)
    from StatisticalModel import util as ref_util
    from StatisticalModel.LHMM import LHMM as RefLHMM

    import jax.numpy as jnp

    from poccala_tpu.models import topology
    from poccala_tpu.ops import gmm_score, hmm
    from poccala_tpu.utils.logmath import NEG_INF

    class _Log:
        def note(self, *a, **k):
            pass

    def forward_f64(log_a, log_pi, log_b):
        """f64 oracle of our forward recursion — separates algorithmic
        parity from f32 precision drift (tests/test_parity_drift.py:
        the round-3 flagship's 1.1e-2 'gap' was f32 accumulation at
        floor-variance magnitudes, not an algorithm difference)."""
        alpha = log_pi + log_b[0]
        for bt in log_b[1:]:
            m = alpha[:, None] + log_a
            mx = m.max(axis=0)
            safe = np.where(mx > NEG_INF / 2, mx, 0.0)
            s = np.log(np.exp(np.maximum(m - safe, -745.0)).sum(axis=0))
            alpha = np.maximum(
                np.where(mx > NEG_INF / 2, safe + s, NEG_INF) + bt, NEG_INF)
        mx = alpha.max()
        return mx + np.log(np.exp(np.maximum(alpha - mx, -745.0)).sum())

    max_ll_diff = 0.0
    max_ll_diff_f64 = 0.0
    max_abs_b = 0.0
    paths_equal = 0
    lls = []
    n_done = 0
    for u in range(min(n_utts, len(batch.feats))):
        t_n = int(batch.t_masks[u].sum())
        l_n = int(batch.label_lens[u])
        if t_n < 4 or l_n < 1:
            continue
        ehmm = topology.build_embedded(
            bank, jnp.asarray(batch.labels[u]), jnp.asarray(l_n),
            cfg.model.state_num, cfg.train.max_label_len,
        )
        scores = gmm_score.gmm_log_scores(
            jnp.asarray(batch.feats[u, :t_n]), bank.means, bank.log_var,
            bank.log_w, normalizer=cfg.model.gaussian_normalizer,
        )
        log_b = np.asarray(topology.embedded_log_b(scores, ehmm))
        n_s = int(ehmm.n_states)
        band = np.asarray(ehmm.band)[:n_s]
        log_pi = np.asarray(ehmm.log_pi)[:n_s]
        prob = log_b[:, :n_s].T                      # [N, T] log domain
        finite_b = prob[prob > NEG_INF / 2]
        if finite_b.size:
            max_abs_b = max(max_abs_b, float(np.abs(finite_b).max()))
        a_lin = densify_band(band)[:n_s, :n_s]

        # ---- ours (the production scan kernels)
        log_a = np.where(a_lin > 0, np.log(np.maximum(a_lin, 1e-300)),
                         NEG_INF)
        la, ll_ours = hmm.forward_log(
            jnp.asarray(log_a),
            jnp.asarray(log_pi), jnp.asarray(prob.T.astype(np.float32)),
            jnp.ones(t_n, bool),
        )
        sc_ours, path_ours, _ = hmm.viterbi_log(
            jnp.asarray(log_a),
            jnp.asarray(log_pi), jnp.asarray(prob.T.astype(np.float32)),
            jnp.ones(t_n, bool),
        )
        ll_f64 = forward_f64(
            log_a.astype(np.float64), log_pi.astype(np.float64),
            prob.T.astype(np.float32).astype(np.float64))

        # ---- the reference, executed
        states = {i: i for i in range(n_s)}
        ref = RefLHMM(states, n_s, _Log(), t=[t_n], transmat=a_lin,
                      probmat=[prob], pi=np.exp(log_pi))
        ref.add_data([np.zeros((t_n, 1))])
        ref._LHMM__generate_result()
        ref_ll = ref_util.log_sum_exp(ref._LHMM__result_f[0][:, -1])
        _, ref_path = RefLHMM.viterbi(_Log(), states, a_lin, prob,
                                      np.exp(log_pi))

        diff = abs(float(ll_ours) - float(ref_ll))
        max_ll_diff = max(max_ll_diff, diff / max(abs(float(ref_ll)), 1.0))
        diff64 = abs(float(ll_f64) - float(ref_ll))
        max_ll_diff_f64 = max(
            max_ll_diff_f64, diff64 / max(abs(float(ref_ll)), 1.0))
        paths_equal += int(np.array_equal(
            np.asarray(path_ours), ref_path.astype(int)))
        lls.append(float(ll_ours))
        n_done += 1
    return {
        "available": True,
        "n_utts": n_done,
        # algorithmic parity: our recursion in f64 vs the executed
        # reference (expected ~1e-12)
        "max_rel_loglik_diff_f64": max_ll_diff_f64,
        # production kernel (f32, renormalized+Kahan) vs the reference:
        # residual is f32 precision, magnitude-dependent
        # (tests/test_parity_drift.py)
        "max_rel_loglik_diff": max_ll_diff,
        # conditioning of the comparison itself: the largest finite
        # |log b| fed to both DPs.  At ~1e7 (reference 1e-6 variance
        # floor + starved senones) the f32 ULP is 1.0 nat and even the
        # reference's own t=0 line (LHMM.py:342, f32-contaminated)
        # rounds whole nats — parity below ~ULP(max_abs_log_b) is
        # unmeasurable.  model.var_floor_scale>0 keeps this ~1e2-1e3
        "max_abs_log_b": max_abs_b,
        "viterbi_paths_identical": paths_equal,
        "logliks": lls,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="WER_r04.json")
    ap.add_argument("--workdir", default="/tmp/wer_proxy")
    ap.add_argument("--vocab", type=int, default=300)
    ap.add_argument("--train-utts", type=int, default=1200)
    ap.add_argument("--test-utts", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lm-weight", type=float, default=6.0)
    ap.add_argument("--tie", action="store_true", default=True)
    ap.add_argument("--no-tie", dest="tie", action="store_false")
    ap.add_argument("--pitch", action="store_true",
                    help="enable the F0 feature column and a "
                         "tone-inclusive (tone-unique) vocabulary")
    ap.add_argument("--noise-snr", type=float, default=None,
                    help="mix synthesized babble into the TEST set at "
                         "this SNR (dB) — noisy-channel evaluation")
    ap.add_argument("--train-noise-snr", default=None, metavar="LO:HI",
                    help="multi-condition training: mix babble into "
                         "each TRAIN utterance at a uniform-random SNR "
                         "from this dB range (e.g. 10:25)")
    ap.add_argument("--cmvn", action="store_true",
                    help="per-utterance cepstral mean normalization "
                         "(frontend.cmvn) — the standard channel/noise "
                         "remedy, flag-gated")
    ap.add_argument("--spectral-subtraction", action="store_true",
                    help="Boll-style magnitude spectral subtraction "
                         "(noise spectrum from the VAD lead-in "
                         "window); frontend.spectral_subtraction")
    ap.add_argument("--cmvn-var", action="store_true",
                    help="additionally scale to unit per-coefficient "
                         "variance (frontend.cmvn_var; implies --cmvn) "
                         "— the flag round 4 shipped unmeasured")
    ap.add_argument("--rescore-order", type=int, default=0,
                    help="if >2, additionally rescore the device n-best "
                         "with an N-gram of this order trained on the "
                         "train transcripts (two-pass decode)")
    ap.add_argument("--homophones", type=int, default=0,
                    help="append up to this many exact-homophone words "
                         "to the vocabulary (identical toned "
                         "pronunciation -> identical acoustics); the "
                         "rescore pass then runs homophone-sausage "
                         "conversion (decoder/rescore.py), where LM "
                         "order directly decides hanzi accuracy")
    ap.add_argument("--lm-structure", type=int, default=0,
                    help="transcript grammar order: 0 = i.i.d. Zipf "
                         "draws (only unigram statistics exist — any "
                         "rescoring order above 1 is informationless "
                         "by construction); 2 = seeded second-order "
                         "grammar shared by train and test, giving "
                         "trigram rescoring a measurable target")
    ap.add_argument("--fullvocab", action="store_true",
                    help="additionally decode the held-out set against "
                         "reference-scale open lexicons (corpus vocab + "
                         "4k-word and 37.5k-word Mandarin.dat "
                         "vocabularies), exact AND block-pruned — WER "
                         "with a trained model where acoustic "
                         "confusability and pruning actually bite")
    ap.add_argument("--cd", action="store_true",
                    help="context-dependent arm: after the CI decode, "
                         "expand to within-word (left, unit, right) "
                         "triples, tie states with per-(base, position) "
                         "phonetic-context decision trees, clone from "
                         "the CI bank, retrain, and decode the "
                         "CD lexicon (models/context.py) — the CI "
                         "numbers in the same artifact are the control")
    ap.add_argument("--cd-senones", type=int, default=0,
                    help="tied-senone budget for the CD trees "
                         "(0 = 3x the CI senone count)")
    ap.add_argument("--cd-map-tau", type=float, default=0.0,
                    help="MAP-smooth retrained CD leaves toward their "
                         "CI parents with this prior strength in "
                         "frames (w = n/(n+tau)); 0 = off — the "
                         "starved-leaf back-off for large senone "
                         "budgets (models/context.py map_smooth_bank)")
    ap.add_argument("--wb-arm", action="store_true",
                    help="additionally decode the test set with a "
                         "Witten-Bell-smoothed FIRST-PASS bigram (per-"
                         "row backoff decoder tables, "
                         "lm/ngram.py bigram_tables_backoff), its own "
                         "dev sweep — the JM-vs-WB first-pass "
                         "comparison (ROADMAP r04 item 3)")
    ap.add_argument("--var-floor-scale", type=float, default=0.0,
                    help="relative per-dim variance floor "
                         "(model.var_floor_scale); 0 = the reference's "
                         "absolute 1e-6 floor, under which starved "
                         "senones collapse to |log b| ~ 1e7 and both "
                         "pipelines lose f32 precision (see parity "
                         "block's max_abs_log_b conditioning field)")
    args = ap.parse_args()

    import jax

    try:
        jax.config.update("jax_compilation_cache_dir",
                          os.path.expanduser("~/.cache/jax_poccala"))
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 5)
    except Exception:
        pass

    from poccala_tpu.config import Config
    from poccala_tpu.decoder.device import DeviceBeamDecoder
    from poccala_tpu.eval.wer import wer as wer_fn
    from poccala_tpu.io.corpus import (Corpus, UnitInventory, scan_corpus,
                                       standard_inventory)
    from poccala_tpu.io.synth_formant import generate_formant_corpus
    from poccala_tpu.lexicon import FlatLexicon, PronunciationLexicon
    from poccala_tpu.lm import Ngram
    from poccala_tpu.train.trainer import Trainer

    t_start = time.time()
    vocab, py = build_vocab(args.vocab, args.seed, with_tone=args.pitch,
                            homophones=args.homophones)
    log(f"vocabulary: {len(vocab)} words"
        + (f" (incl. up to {args.homophones} homophones)"
           if args.homophones else " (pronunciation-unique)"))

    # ---- corpora: unseen speakers for the held-out set
    train_dir = os.path.join(args.workdir, "train")
    test_dir = os.path.join(args.workdir, "test")
    t0 = time.time()
    a_tr, l_tr, trans_tr = generate_formant_corpus(
        train_dir, vocab, py, num_utts=args.train_utts, n_speakers=8,
        seed=args.seed + 11, sil_token="sil",
        markov_order=args.lm_structure, grammar_seed=args.seed,
    )
    a_te, l_te, trans_te = generate_formant_corpus(
        test_dir, vocab, py, num_utts=args.test_utts, n_speakers=3,
        seed=args.seed + 97, sil_token="sil",
        markov_order=args.lm_structure, grammar_seed=args.seed,
    )
    log(f"synthesized {args.train_utts}+{args.test_utts} utts "
        f"in {time.time()-t0:.0f}s")

    # ---- optional babble-noise channel (ROADMAP noisy-channel eval):
    # a synthesized NOISEX-style multi-talker babble track, mixed over
    # the whole waveform INCLUDING the VAD noise-estimation window —
    # the production VAD must cope, exactly as with a real noisy channel
    if args.noise_snr is not None or args.train_noise_snr:
        from poccala_tpu.io import wav as wav_io
        from poccala_tpu.io.synth_formant import (make_babble_track,
                                                  mix_at_snr)

        t0 = time.time()
        # SEPARATE noise tracks for train and test (distinct seeds,
        # disjoint talker-vocabulary slices): the test babble waveform
        # is never seen during multi-condition training, so the noisy
        # WER measures robustness to unseen noise (round-3 used one
        # shared track — its noise numbers were optimistic)
        babble_seed_tr = args.seed + 5
        babble_seed_te = args.seed + 6
        half = len(vocab) // 2
        babble_tr = make_babble_track(vocab[:half][:120], py,
                                      duration_s=30.0, n_talkers=6,
                                      seed=babble_seed_tr)
        babble_te = make_babble_track(vocab[half:][:120], py,
                                      duration_s=30.0, n_talkers=6,
                                      seed=babble_seed_te)

        def noisify(audio_dir, babble, snr_lo, snr_hi, seed):
            rng = np.random.default_rng(seed)
            n = 0
            for name in sorted(os.listdir(audio_dir)):
                if not name.endswith(".wav"):
                    continue
                p = os.path.join(audio_dir, name)
                data, rate = wav_io.load_wav(p)
                snr = float(rng.uniform(snr_lo, snr_hi))
                wav_io.write_wav(p, mix_at_snr(data, babble, snr, rng),
                                 rate)
                n += 1
            return n

        if args.train_noise_snr:
            lo, hi = (float(x) for x in args.train_noise_snr.split(":"))
            n = noisify(a_tr, babble_tr, lo, hi, args.seed + 31)
            log(f"multi-condition train: babble at U[{lo},{hi}] dB "
                f"over {n} utts")
        if args.noise_snr is not None:
            n = noisify(a_te, babble_te, args.noise_snr, args.noise_snr,
                        args.seed + 32)
            log(f"noisy test: babble at {args.noise_snr} dB over {n} utts")
        log(f"babble mixing took {time.time()-t0:.0f}s")

    # ---- config (BASELINE config-2 shape on XIF_tone units)
    cfg = Config()
    cfg.model.state_num = 5
    cfg.model.mix_level = 2
    cfg.model.max_mix_level = 6
    cfg.frontend.pitch = bool(args.pitch)
    cfg.frontend.cmvn = bool(args.cmvn or args.cmvn_var)
    cfg.frontend.cmvn_var = bool(args.cmvn_var)
    cfg.frontend.spectral_subtraction = bool(args.spectral_subtraction)
    cfg.model.var_floor_scale = float(args.var_floor_scale)
    cfg.train.label_format = "pinyin"
    cfg.train.load_line = 1
    cfg.train.max_frames = 512
    cfg.train.max_label_len = 32
    cfg.train.batch_size = 64
    cfg.paths.audio_file_path = a_tr
    cfg.paths.label_file_path = l_tr
    # XIF_tone plus an explicit silence unit: the reference VAD's
    # adaptive threshold (reproduced quirks included) keeps most of the
    # lead/trail/pause silence on this corpus, so silence is modeled
    # like any other unit and decoded as a strippable <sil> filler —
    # standard LVCSR practice
    inv = UnitInventory(standard_inventory("XIF_tone") + ["sil"])

    corpus = Corpus(cfg, inv)
    t0 = time.time()
    batches = list(corpus.batches())
    n_train = sum(len(b.feats) for b in batches)
    log(f"featurized {n_train} train utts in {time.time()-t0:.0f}s")

    # ---- train: scheme 2 (flat start + embedded BW), then scheme 1
    # rounds with mixture growth (Controller.py:208-213 schedule, wider)
    tr = Trainer(cfg, inv)
    t0 = time.time()
    tr.auto(batches, t=5, mode=2)
    tr.auto(batches, t=4, mode=1, add_mix=True)
    tr.auto(batches, t=3, mode=2, init=False)
    log(f"trained in {time.time()-t0:.0f}s; "
        f"final loglik/utt={tr.history[-1]['loglik']/max(n_train,1):.1f}")
    bank = tr.export_bank()

    from poccala_tpu.train import checkpoint as ckpt_mod
    ckpt_mod.save_checkpoint(os.path.join(args.workdir, "ckpt"), bank,
                             {"mix_level": tr.mix_level}, units=inv.units)

    tied_info = None
    if args.tie:
        from poccala_tpu.models import tying

        target = int(bank.num_states * 0.6)
        t0 = time.time()
        tied = tying.tie_by_kmeans(bank, target_senones=target)
        tr.bank = tied
        tr.auto(batches, t=2, mode=2, init=False)
        bank = tr.export_bank()
        tied_info = {"senones": int(bank.num_states), "target": target,
                     "seconds": round(time.time() - t0, 1)}
        log(f"tied to {bank.num_states} senones (config 3), retrained")

    # ---- decode held-out set
    lex = PronunciationLexicon()
    lex.generate(vocab, py)
    # silence filler word over the trained sil unit (two-unit node)
    lex.lexicon.setdefault("sil", {}).setdefault("sil,sil", {})["word"] = \
        ["<sil>"]
    flat = FlatLexicon.from_tree(lex.lexicon, inv)
    lm = Ngram(2)
    lm.train([words for _, words in trans_tr])
    log(f"lexicon: {flat.n_nodes} nodes / {len(vocab)} words")

    # LM-weight sweep on a train-set dev slice (standard practice: the
    # held-out set stays untouched until the final decode)
    dev = batches[0]
    dev_nf = dev.t_masks.sum(axis=1).astype(np.int32)
    dev_refs = [words for _, words in trans_tr[: len(dev.feats)]]
    best_w, best_pen, best_wer = args.lm_weight, 0.0, None
    for w in (12.0, 20.0, 28.0):
        for pen in (20.0, 40.0, 60.0, 80.0):
            d = DeviceBeamDecoder(bank, flat, lm=lm, lm_weight=w,
                                  word_penalty=pen)
            out = d.decode_batch(dev.feats, dev_nf)
            hy = [[x for x in h[0].words if x != "<sil>"] if h else []
                  for h in out]
            r = wer_fn(dev_refs, hy)
            log(f"  sweep: lm_weight={w} word_penalty={pen} "
                f"dev WER={r.wer:.3f}")
            if best_wer is None or r.wer < best_wer:
                best_w, best_pen, best_wer = w, pen, r.wer
    log(f"sweep picked lm_weight={best_w} word_penalty={best_pen} "
        f"(dev WER={best_wer:.3f})")
    dec = DeviceBeamDecoder(bank, flat, lm=lm, lm_weight=best_w,
                            word_penalty=best_pen)

    test_pairs = scan_corpus(a_te, l_te)
    test_corpus = Corpus(cfg, inv, pairs=test_pairs)
    truth_of = dict(trans_te)

    # batched featurization (native WAV loader + one fixed-shape device
    # frontend program); refs follow the pairs order — every pair must
    # survive (labels round-trip by construction), asserted below
    t0 = time.time()
    feats_l, nf_l = [], []
    for batch in test_corpus.batches():
        nf_b = batch.t_masks.sum(axis=1).astype(np.int32)
        feats_l.append(batch.feats)
        nf_l.append(nf_b)
    feats = np.concatenate(feats_l)
    nf = np.concatenate(nf_l)
    refs = [truth_of[os.path.basename(w)[: -len(".wav")]]
            for w, _ in test_pairs]
    assert len(refs) == len(feats), (len(refs), len(feats))
    audio_seconds = float(nf.sum()) * 0.01
    feat_s = time.time() - t0

    t0 = time.time()
    nb = 8 if args.rescore_order > 2 else 1
    nbest_all = []
    for lo in range(0, len(feats), 128):
        nbest_all.extend(dec.decode_batch(
            feats[lo: lo + 128], nf[lo: lo + 128], return_nbest=nb))
    hyps = [[w for w in h[0].words if w != "<sil>"] if h else []
            for h in nbest_all]
    decode_s = time.time() - t0
    res = wer_fn(refs, hyps)
    log(f"decoded {len(hyps)} utts ({audio_seconds:.0f} audio-s) "
        f"in {decode_s:.0f}s (+{feat_s:.0f}s frontend)")
    log(f"WER={res.wer:.3f} SER={res.ser:.3f}")

    # optional open-vocabulary arm: the SAME trained model and LM
    # operating point decoded against reference-scale lexicons, exact
    # and block-pruned — the missing validation of pruning on trained
    # (non-separable) scores and of accuracy at the vocabulary the
    # reference designed for (Lexicon/PinYin.py:39-56,
    # PronunciationLexicon.py:45-94; VERDICT r04 missing #2 / weak #1)
    fullvocab_block = None
    if args.fullvocab:
        from poccala_tpu.lexicon.build import DEFAULT_DAT, reference_words

        fv_rows = []
        for tag, ns, nm in (("4k", 2500, 1500), ("37k", 26000, 12000)):
            t0 = time.time()
            ref_ws, _ = reference_words(DEFAULT_DAT, n_single=ns,
                                        n_multi=nm, seed=args.seed)
            have = set(vocab)
            words_big = list(vocab) + [w for w in ref_ws
                                       if w not in have]
            lex_big = PronunciationLexicon()
            lex_big.generate(words_big, py)
            lex_big.lexicon.setdefault("sil", {}).setdefault(
                "sil,sil", {})["word"] = ["<sil>"]
            flat_big = FlatLexicon.from_tree(lex_big.lexicon, inv)
            build_s = time.time() - t0
            log(f"fullvocab {tag}: {flat_big.n_nodes} nodes / "
                f"{len(words_big)} words (built in {build_s:.0f}s)")
            for mode, kw in (("exact", {}),
                             ("pruned_8x256", dict(block_size=256,
                                                   active_blocks=8)),
                             ("pruned_16x256", dict(block_size=256,
                                                    active_blocks=16))):
                d = DeviceBeamDecoder(bank, flat_big, lm=lm,
                                      lm_weight=best_w,
                                      word_penalty=best_pen, **kw)
                t0 = time.time()
                hyps_fv = []
                for lo in range(0, len(feats), 128):
                    out = d.decode_batch(feats[lo: lo + 128],
                                         nf[lo: lo + 128])
                    hyps_fv.extend(
                        [w for w in h[0].words if w != "<sil>"]
                        if h else [] for h in out)
                dt = time.time() - t0
                r = wer_fn(refs, hyps_fv)
                row = {
                    "scale": tag,
                    "mode": mode,
                    "vocab_words": len(words_big),
                    "lexicon_nodes": int(flat_big.n_nodes),
                    "wer": round(r.wer, 4),
                    "ser": round(r.ser, 4),
                    "wer_delta_vs_closed": round(r.wer - res.wer, 4),
                    # first batch compiles inside the timed loop — WER
                    # is the point here, not throughput
                    "decode_seconds_incl_compile": round(dt, 1),
                }
                fv_rows.append(row)
                log(f"fullvocab {tag}/{mode}: WER={r.wer:.3f} "
                    f"({dt:.0f}s incl. compile)")
        # the exact-vs-pruned WER delta with trained scores is the
        # point (synthetic-separable agreement was the r04 evidence)
        deltas = {}
        for tag in ("4k", "37k"):
            ex = next(r for r in fv_rows
                      if r["scale"] == tag and r["mode"] == "exact")
            for r in fv_rows:
                if r["scale"] == tag and r["mode"] != "exact":
                    deltas[f"{tag}/{r['mode']}"] = round(
                        r["wer"] - ex["wer"], 4)
        fullvocab_block = {
            "closed_vocab_wer": round(res.wer, 4),
            "lm_note": ("same bigram + operating point as the closed-"
                        "vocab decode; distractor words score the "
                        "add-1 unigram floor"),
            "rows": fv_rows,
            "pruned_minus_exact_wer": deltas,
        }

    # optional context-dependent arm (BASELINE config 3's "triphone-
    # style" clause; the reference is strictly CI, so the CI numbers
    # above are the control — same corpus, same floor, same LM)
    cd_block = None
    if args.cd:
        import dataclasses as _dc

        from poccala_tpu.io.synth_formant import _synthesizable_entries
        from poccala_tpu.models import context as ctx_mod
        from poccala_tpu.train import alignment as align_mod
        from poccala_tpu.train.trainer import Trainer as _Trainer

        t_cd0 = time.time()
        entries = _synthesizable_entries(vocab, py)
        # training-label forms: the reading the corpus synthesizes
        word_units_of = {
            w: [[inv.id_of[a], inv.id_of[b]] for a, b in us]
            for w, _, us in entries
        }
        # lexicon forms: ALL reading combinations (polyphonic chars),
        # capped per word — the CI PronunciationLexicon covers every
        # combination, so the CD graph must too for a fair pair;
        # alternate-reading triples get zero training occupancy and
        # back off through the trees
        cd_entries = []
        for w, _, _ in entries:
            combos = ctx_mod.reading_combos(py, w, inv.id_of) \
                or [word_units_of[w]]
            for c in combos:
                cd_entries.append((w, c))
            if word_units_of[w] not in combos:
                cd_entries.append((w, word_units_of[w]))
        sil_id = inv.id_of["sil"]
        cd_inv = ctx_mod.CDInventory.from_words(
            [[u for s in syls for u in s] for _, syls in cd_entries],
            inv, context_free=[sil_id])
        log(f"cd: {len(cd_inv)} triples over {len(inv)} base units "
            f"({len(cd_entries)} word-reading entries)")

        # CD labels + CI-alignment stats over the whole train set
        import jax.numpy as jnp
        assert len(trans_tr) == n_train, (len(trans_tr), n_train)
        cursor = 0
        cd_batches = []
        n_cd_states = cfg.model.emit_states
        acc_cd = ctx_mod.TripleStatsAccumulator(
            len(cd_inv), n_cd_states, cfg.frontend.feat_dim)
        for batch in batches:
            nb_ = len(batch.feats)
            word_seqs = [
                [[u for s in word_units_of[w] for u in s]
                 for w in trans_tr[cursor + j][1]]
                for j in range(nb_)
            ]
            cursor += nb_
            cd_labels = ctx_mod.expand_labels(
                batch.labels, batch.label_lens, word_seqs, cd_inv)
            _, lp = align_mod.align_batch(
                bank, jnp.asarray(batch.labels),
                jnp.asarray(batch.label_lens), jnp.asarray(batch.feats),
                jnp.asarray(batch.t_masks), cfg.model.state_num,
                cfg.train.max_label_len,
                normalizer=cfg.model.gaussian_normalizer)
            lp = np.asarray(lp)
            ok = align_mod.check_alignment(lp, batch.labels,
                                           batch.label_lens)
            acc_cd.add(batch.feats, cd_labels, lp, utt_ok=ok)
            cd_batches.append(_dc.replace(batch, labels=cd_labels))
        target = args.cd_senones or 3 * bank.num_states
        trees = ctx_mod.grow_context_trees(
            cd_inv, acc_cd.occ, acc_cd.mean, acc_cd.ex2,
            target_senones=target, min_occ=16.0)
        cd_bank = ctx_mod.build_cd_bank(bank, cd_inv, trees)
        log(f"cd: tied to {trees.n_senones} senones "
            f"(target {target}, {len(trees.splits_log)} splits)")

        tr_cd = _Trainer(cfg, UnitInventory(
            [f"cd{k}" for k in range(len(cd_inv))]))
        tr_cd.bank = cd_bank
        tr_cd.mix_level = tr.mix_level
        tr_cd._var_floor_vec = tr._var_floor_vec
        # reinit=False: EM refit FROM the clones — preserves component
        # correspondence with the CI parents (map_smooth_bank premise)
        tr_cd.scheme1_round(cd_batches, init=False, smem=False,
                            reinit=False)
        tr_cd.auto(cd_batches, t=2, mode=2, init=False)
        cd_bank = tr_cd.export_bank()
        if args.cd_map_tau > 0:
            cd_bank = ctx_mod.map_smooth_bank(
                cd_bank, bank, cd_inv, trees, acc_cd.occ,
                tau=args.cd_map_tau)
            log(f"cd: MAP-smoothed toward CI parents (tau="
                f"{args.cd_map_tau:g} frames)")
        log(f"cd: retrained in {time.time()-t_cd0:.0f}s")

        cd_flat = ctx_mod.build_cd_lexicon(
            cd_entries, cd_inv, sil_word=("<sil>", sil_id))
        log(f"cd lexicon: {cd_flat.n_nodes} nodes "
            f"(ci {flat.n_nodes})")

        cw, cpen, cwer = best_w, best_pen, None
        for w_ in (12.0, 20.0, 28.0):
            for pen in (20.0, 40.0, 60.0, 80.0):
                d = DeviceBeamDecoder(cd_bank, cd_flat, lm=lm,
                                      lm_weight=w_, word_penalty=pen)
                out = d.decode_batch(dev.feats, dev_nf)
                hy = [[x for x in h[0].words if x != "<sil>"]
                      if h else [] for h in out]
                r = wer_fn(dev_refs, hy)
                if cwer is None or r.wer < cwer:
                    cw, cpen, cwer = w_, pen, r.wer
        log(f"cd sweep picked lm_weight={cw} word_penalty={cpen} "
            f"(dev WER={cwer:.3f})")
        dec_cd = DeviceBeamDecoder(cd_bank, cd_flat, lm=lm,
                                   lm_weight=cw, word_penalty=cpen)
        t0 = time.time()
        hyps_cd = []
        for lo in range(0, len(feats), 128):
            out = dec_cd.decode_batch(feats[lo: lo + 128],
                                      nf[lo: lo + 128])
            hyps_cd.extend(
                [w for w in h[0].words if w != "<sil>"] if h else []
                for h in out)
        res_cd = wer_fn(refs, hyps_cd)
        cd_block = {
            "triples": int(len(cd_inv)),
            "senones": int(cd_bank.num_states),
            "target_senones": int(target),
            "map_tau": float(args.cd_map_tau),
            "splits": len(trees.splits_log),
            "top_splits": trees.splits_log[:12],
            "lexicon_nodes": int(cd_flat.n_nodes),
            "lm_weight": cw,
            "word_penalty": cpen,
            "dev_wer": round(cwer, 4),
            "wer": round(res_cd.wer, 4),
            "ser": round(res_cd.ser, 4),
            "wer_delta_vs_ci": round(res_cd.wer - res.wer, 4),
            "decode_seconds": round(time.time() - t0, 1),
            "train_seconds": round(time.time() - t_cd0, 1),
        }
        log(f"CD WER={res_cd.wer:.3f} (CI control {res.wer:.3f})")

    # optional Witten-Bell first-pass arm: same trained model, same
    # sweep grid, only the bigram smoothing differs (JM's context-
    # independent backoff column vs WB's per-row lambda) — the decoder-
    # table capability round 4 left designed-but-unbuilt (ROADMAP 3)
    wb_block = None
    if args.wb_arm:
        lm_wb = Ngram(2, smoothing="wb")
        lm_wb.train([words for _, words in trans_tr])
        bw_w, bw_pen, bw_wer = args.lm_weight, 0.0, None
        for w in (12.0, 20.0, 28.0):
            for pen in (20.0, 40.0, 60.0, 80.0):
                d = DeviceBeamDecoder(bank, flat, lm=lm_wb, lm_weight=w,
                                      word_penalty=pen)
                out = d.decode_batch(dev.feats, dev_nf)
                hy = [[x for x in h[0].words if x != "<sil>"] if h else []
                      for h in out]
                r = wer_fn(dev_refs, hy)
                if bw_wer is None or r.wer < bw_wer:
                    bw_w, bw_pen, bw_wer = w, pen, r.wer
        log(f"wb sweep picked lm_weight={bw_w} word_penalty={bw_pen} "
            f"(dev WER={bw_wer:.3f})")
        dec_wb = DeviceBeamDecoder(bank, flat, lm=lm_wb, lm_weight=bw_w,
                                   word_penalty=bw_pen)
        t0 = time.time()
        hyps_wb = []
        for lo in range(0, len(feats), 128):
            out = dec_wb.decode_batch(feats[lo: lo + 128],
                                      nf[lo: lo + 128])
            hyps_wb.extend(
                [w for w in h[0].words if w != "<sil>"] if h else []
                for h in out)
        res_wb = wer_fn(refs, hyps_wb)
        wb_block = {
            "smoothing": "wb (per-row backoff decoder tables)",
            "lm_weight": bw_w,
            "word_penalty": bw_pen,
            "dev_wer": round(bw_wer, 4),
            "wer": round(res_wb.wer, 4),
            "ser": round(res_wb.ser, 4),
            "wer_delta_vs_jm_first_pass": round(res_wb.wer - res.wer, 4),
            "decode_seconds": round(time.time() - t0, 1),
        }
        log(f"WB first pass: WER={res_wb.wer:.3f} (JM {res.wer:.3f})")

    # optional two-pass trigram: bigram decode n-best, higher-order
    # rescore (Decoder.py:201-204 per-order Ngram intent)
    rescore_block = None
    if args.rescore_order > 2:
        from poccala_tpu.decoder.rescore import rescore_nbest

        # rescore LMs train on transcripts EXCLUDING the dev slice: the
        # dev sentences used for the weight sweep must not sit inside
        # the rescore LM's own training data, or higher weights look
        # artificially good on dev and the sweep is biased toward the
        # large-weight end (ADVICE r04).  The same-treatment bigram
        # control (sausage arm) gets the identical exclusion.
        n_dev = len(dev.feats)
        rescore_sents = [words for _, words in trans_tr[n_dev:]]
        tri = Ngram(args.rescore_order, smoothing="wb")
        tri.train(rescore_sents)
        lm_rs = Ngram(2)
        lm_rs.train(rescore_sents)
        # the rescore LM weight is tuned separately on the dev slice
        # (standard two-pass practice: the acoustic margins between
        # n-best entries are set by the decode weight, so the stronger
        # LM usually needs a larger weight to move the ranking)
        dev_nb = dec.decode_batch(dev.feats, dev_nf, return_nbest=nb)
        best_rw, best_rwer = best_w, None
        for rw in (best_w, 2 * best_w, 4 * best_w, 8 * best_w):
            dl = rescore_nbest(dev_nb, lm, tri, best_w, best_pen,
                               rescore_lm_weight=rw)
            hy = [[x for x in h[0].words if x != "<sil>"] if h else []
                  for h in dl]
            r = wer_fn(dev_refs, hy)
            log(f"  rescore sweep: weight={rw} dev WER={r.wer:.3f}")
            if best_rwer is None or r.wer < best_rwer:
                best_rw, best_rwer = rw, r.wer
        re_lists = rescore_nbest(nbest_all, lm, tri, best_w, best_pen,
                                 rescore_lm_weight=best_rw)
        hyps_re = [[w for w in h[0].words if w != "<sil>"] if h else []
                   for h in re_lists]
        res_re = wer_fn(refs, hyps_re)
        rescore_block = {
            "order": args.rescore_order,
            "nbest": nb,
            "smoothing": "wb",
            # sweep-bias control: rescore LMs never see the dev
            # sentences their weight is tuned on
            "rescore_lm_excludes_dev_slice": n_dev,
            "rescore_lm_weight": best_rw,
            "wer": round(res_re.wer, 4),
            "ser": round(res_re.ser, 4),
            "wer_delta_vs_bigram": round(res_re.wer - res.wer, 4),
        }
        # homophone sausage: with homophones in the vocabulary the
        # decoded word sequence is only one member of an acoustically
        # identical family; LM order directly decides hanzi accuracy
        # (the pinyin->hanzi task the reference's Ngram stack serves)
        from poccala_tpu.decoder.rescore import (homophone_groups,
                                                 rescore_sausage)

        groups = homophone_groups(flat)
        if groups:
            def sausage_wer(rlm, rw, lists, rf):
                sl = rescore_sausage(lists, groups, lm, rlm,
                                     best_w, best_pen,
                                     rescore_lm_weight=rw)
                hy = [[x for x in h[0].words if x != "<sil>"]
                      if h else [] for h in sl]
                return wer_fn(rf, hy)

            def tune_sausage(rlm):
                """Per-method dev tuning: the two orders get the same
                treatment, only the LM order differs."""
                bw, bwer = best_w, None
                for rw in (best_w, 2 * best_w, 4 * best_w):
                    r = sausage_wer(rlm, rw, dev_nb, dev_refs)
                    if bwer is None or r.wer < bwer:
                        bw, bwer = rw, r.wer
                return bw

            rw_bi = tune_sausage(lm_rs)
            rw_tri = tune_sausage(tri)
            s_bi = sausage_wer(lm_rs, rw_bi, nbest_all, refs)
            s_tri = sausage_wer(tri, rw_tri, nbest_all, refs)
            rescore_block["sausage"] = {
                "homophone_words": len(groups),
                "bigram_lm_weight": rw_bi,
                "trigram_lm_weight": rw_tri,
                "bigram_wer": round(s_bi.wer, 4),
                "trigram_wer": round(s_tri.wer, 4),
                "trigram_delta_vs_bigram_sausage":
                    round(s_tri.wer - s_bi.wer, 4),
                "trigram_delta_vs_plain": round(s_tri.wer - res.wer, 4),
            }
            log(f"sausage: bigram {s_bi.wer:.3f} trigram "
                f"{s_tri.wer:.3f} (plain {res.wer:.3f})")
        log(f"trigram-rescored WER={res_re.wer:.3f} "
            f"(bigram {res.wer:.3f})")

    # 25+ utterances: the repo's most-cited correctness claim deserves
    # more than a 5-utterance sample (VERDICT r04 weak #7); cost is
    # minutes (the block executes the actual reference NumPy LHMM)
    parity = parity_check(bank, batches[0], cfg, n_utts=32)
    log(f"parity: {parity}")

    artifact = {
        "artifact": os.path.splitext(os.path.basename(args.out))[0],
        "corpus": "formant-synthesized Mandarin proxy (coarticulated "
                  "source-filter synthesis, 8 train / 3 unseen test "
                  "speakers)",
        "proxy_disclosure": (
            "NOT real speech. This environment has zero network egress "
            "and ships no speech corpus (no THCHS-30 / data_24 on disk), "
            "so the BASELINE 'WER parity on held-out Mandarin' clause is "
            "evidenced on the closest obtainable proxy: formant-"
            "synthesized coarticulated Mandarin with tone contours and "
            "speaker variation (poccala_tpu/io/synth_formant.py). All "
            "other pipeline stages are the production ones."
        ),
        "vocab_words": len(vocab),
        "train_utts": n_train,
        "test_utts": len(hyps),
        "test_audio_seconds": round(audio_seconds, 1),
        "unit_inventory": "XIF_tone + sil",
        "pitch_feature": bool(args.pitch),
        "noise": (None if args.noise_snr is None and not args.train_noise_snr
                  else {
                      "kind": "synthesized 6-talker babble "
                              "(make_babble_track)",
                      "test_snr_db": args.noise_snr,
                      "train_snr_db": args.train_noise_snr or "clean",
                      # distinct tracks: test noise unseen in training
                      "train_babble_seed": args.seed + 5,
                      "test_babble_seed": args.seed + 6,
                      "disjoint_talker_vocab": True,
                  }),
        "cmvn": bool(args.cmvn or args.cmvn_var),
        "cmvn_var": bool(args.cmvn_var),
        "spectral_subtraction": bool(args.spectral_subtraction),
        "var_floor_scale": float(args.var_floor_scale),
        "lm_structure": int(args.lm_structure),
        "homophones_requested": int(args.homophones),
        "fullvocab": fullvocab_block,
        "context_dependent": cd_block,
        "first_pass_wb": wb_block,
        "rescore": rescore_block,
        "vocab_uniqueness": ("pronunciation-unique incl. tone"
                             if args.pitch else
                             "pronunciation-unique ignoring tone"),
        "senones": int(bank.num_states),
        "mix_level": int(tr.mix_level),
        "tied": tied_info,
        "lexicon_nodes": int(flat.n_nodes),
        "lm": "bigram (interpolated, trained on train transcripts)",
        "lm_weight": best_w,
        "word_penalty": best_pen,
        "lm_dev_wer": round(best_wer, 4),
        "wer": round(res.wer, 4),
        "ser": round(res.ser, 4),
        "substitutions": res.substitutions,
        "deletions": res.deletions,
        "insertions": res.insertions,
        "ref_tokens": res.ref_tokens,
        "decode_seconds": round(decode_s, 1),
        "samples": [{"ref": r, "hyp": h}
                    for r, h in list(zip(refs, hyps))[:10]],
        "reference_parity": parity,
        "train_history": tr.history,
        "wall_seconds": round(time.time() - t_start, 1),
    }
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1, ensure_ascii=False)
    print(json.dumps({"metric": "wer_proxy", "value": res.wer,
                      "ser": res.ser, "test_utts": len(hyps)}))


if __name__ == "__main__":
    main()
