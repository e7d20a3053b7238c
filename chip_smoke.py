#!/usr/bin/env python3
"""End-to-end check that poccala_tpu trains, decodes and serves on a GPU.

    python chip_smoke.py            # one GPU, BASELINE config-2 width
    python chip_smoke.py --four     # four GPUs: state-sharded train step and
                                    # sharded decode, each against one card
    python chip_smoke.py --rehearse [--four]
                                    # tiny sizes on whatever backend JAX has
                                    # (a CPU rehearsal); prints no result line

The one-GPU run drives the main path through the entry points a user
calls, all in this one process (no child process opens the card):

1. device: the platform must be ``gpu``; prints the card (from
   ``nvidia-smi``, read by a child that never imports JAX), JAX's view of
   it, ``XLA_FLAGS`` and the compile-cache directory;
2. train: a seeded formant-synthesized corpus (256 utterances of about
   4 s) on the XIF inventory (62 units x 3 emitting states = 186
   senones, 8 mixtures, 39-dim MFCC+D+DD): ``cli train --mode 2`` for
   three embedded Baum-Welch epochs (log-likelihoods finite and
   non-decreasing), then one ``--mode 1`` realignment round;
3. oracle: one E-step, the Viterbi alignment and the MFCC features on
   the card against the float64 NumPy oracles of ``tests/``;
4. checkpoint: the saved bank is bit-identical to the one in memory;
5. decode and serve: held-out utterances through ``cli decode --decoder
   device`` and ``cli serve``, the device 1-best against the host
   ``decoder/beam.py`` oracle, and the streaming API against one-shot.

Every phase must pass.  The last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``;
nothing is printed there when a phase fails or no GPU is found.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)


@dataclass(frozen=True)
class Sizes:
    n_train: int = 256           # one batch of 256 utterances
    words_per_utt: tuple = (10, 14)   # ~4 s of speech
    n_test: int = 4
    bw_epochs: int = 3
    mix: int = 8
    max_frames: int = 512
    max_label_len: int = 32
    oracle_utts: int = 4
    host_max_tokens: int = 128
    # --four: BASELINE config-3 width (683 units x 3 = 2,049 senones)
    c3_units: int = 683
    c3_mix: int = 16
    c3_batch: int = 16
    c3_frames: int = 320
    c3_labels: int = 16
    dec_units: int = 202         # XIF_tone: 606 senones
    dec_mix: int = 8
    dec_batch: int = 16


FULL = Sizes()
TINY = Sizes(n_train=8, words_per_utt=(2, 4), n_test=2, bw_epochs=2,
             mix=2, max_frames=256, max_label_len=16, oracle_utts=2,
             host_max_tokens=64, c3_units=21, c3_mix=2, c3_batch=8,
             c3_frames=48, c3_labels=4, dec_units=202, dec_mix=2,
             dec_batch=8)

# Oracle bars (max |device - oracle| / max |oracle| unless noted).  Each
# sits between what f32 arithmetic reaches and what one TF32 pass (10
# mantissa bits) would give:
#  * features: 3e-4 absolute, the frontend's accuracy bar;
#  * GMM state scores, forward log-likelihoods and Viterbi scores: 1e-4.
#    The expansion x²/σ² - 2xμ/σ² + μ²/σ² cancels terms ~|x|²/σ² down
#    to ~1; f32 leaves ~1e-5 of the largest score, TF32 ~1e-2;
#  * Baum-Welch statistics: 1e-2.  The log-domain f32 forward-backward
#    over T frames carries ~sqrt(T) ULPs of |log P(O)| into every
#    posterior of an utterance (sqrt(400) x 2.4e-4 ≈ 5e-3 at
#    |log P| = 3e3), so the sums move together by that much whatever
#    the matmul precision (an H100 run measured 2.8e-3);
#  * M-step means and variances: 1e-2 of E[x²] + μ_old² (the variance
#    is E[x²] - 2μ_old E[x] + μ_old², which cancels).  The
#    per-utterance posterior noise above does not cancel across the
#    utterances a mixture pools (an H100 run measured 4.7e-3);
#  * alignment: at most 1% of frames on another label position
#    (near-ties between adjacent states flip under f32 vs f64).
TOL = {"features": 3e-4, "scores": 1e-4, "loglik": 1e-4, "bw": 1e-2,
       "mstep": 1e-2, "viterbi": 1e-4, "align_flips": 0.01}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """``name, power.limit`` of the first card, from a child process
    that does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    log(f"== {name}")
    yield
    log(f"== {name}: passed in {time.perf_counter() - t0:.1f} s")


def check(name: str, err: float, tol: float, precision: str) -> None:
    ok = err <= tol
    log(f"  {name:<34s} err {err:.3e}  tol {tol:.1e}  "
        f"precision {precision}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: error {err:.3e} above {tol:.1e}")


def rel_err(got, want) -> float:
    """max |got - want| / max |want| over the entries that are not the
    log-zero sentinel (NEG_INF = -1e30) in ``want``."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    live = want > -1e29
    if not live.any():
        return 0.0
    return float(np.max(np.abs(got - want)[live])
                 / max(np.max(np.abs(want[live])), 1e-30))


# ----------------------------------------------------------------------
# corpus
# ----------------------------------------------------------------------

def xif_words():
    """Single-character words of the built-in table with one reading,
    unique once tones are dropped (the XIF inventory is toneless), and
    a Mandarin.dat-format table of their toneless readings."""
    from poccala_tpu.lexicon import PinYin
    from poccala_tpu.lexicon.builtin_table import BUILTIN_PINYIN

    py = PinYin()
    words, seen = [], set()
    for ch, readings in BUILTIN_PINYIN.items():
        if len(readings) != 1:
            continue
        key = py.word2pinyin(ch)[0][0].rstrip("0123456789")
        if key in seen:
            continue
        seen.add(key)
        words.append(ch)
    dat = "".join(f"{ord(w):X}\t{BUILTIN_PINYIN[w][0].rstrip('0123456789')}\n"
                  for w in words)
    return words, dat


def make_corpus(out_dir: str, words, n: int, seed: int, words_per_utt):
    """Formant-synthesized utterances; each label file gains a third
    line with the XIF unit sequence (tones dropped) for training."""
    from poccala_tpu.io.synth_formant import generate_formant_corpus
    from poccala_tpu.lexicon import PinYin

    py = PinYin()
    audio, label, transcripts = generate_formant_corpus(
        out_dir, words, py, num_utts=n, words_per_utt=words_per_utt,
        seed=seed)
    for name, _ in transcripts:
        path = os.path.join(label, name + ".wav.trn")
        with open(path) as f:
            lines = f.read().splitlines()
        units = [u.rstrip("0123456789") for syl in lines[1].split()
                 for u in py.syllable_to_units(syl)]
        with open(path, "a") as f:
            f.write(" ".join(units) + "\n")
    return audio, label, transcripts


def train_overrides(audio, label, sz: Sizes, seed: int):
    sets = {
        "paths.audio_file_path": audio, "paths.label_file_path": label,
        "train.load_line": 2, "train.label_format": "units",
        "train.batch_size": sz.n_train, "train.max_frames": sz.max_frames,
        "train.max_label_len": sz.max_label_len, "train.seed": seed,
        "model.mix_level": sz.mix, "model.max_mix_level": sz.mix,
        # relative variance floor: the reference's absolute 1e-6 floor
        # lets starved senones collapse (see ModelConfig.var_floor_scale)
        "model.var_floor_scale": 0.01,
    }
    argv = ["--units", "XIF"]
    for k, v in sets.items():
        argv += ["--set", f"{k}={v}"]
    return argv


def config_of(base):
    """The (config, inventory) the CLI builds from ``base``."""
    from poccala_tpu.config import Config
    from poccala_tpu.io.corpus import UnitInventory

    cfg = Config()
    cfg.apply_overrides(base[3::2])          # the "--set" values
    return cfg, UnitInventory.standard(base[1])


# ----------------------------------------------------------------------
# oracle comparison
# ----------------------------------------------------------------------

def oracle_check(bank, feats, t_masks, labels, label_lens, state_num,
                 max_label_len, wav_signal=None):
    """One E-step, the alignment and (given a signal) the MFCC features
    against the float64 NumPy oracles of ``tests/``; raises on a miss.
    Returns the list of (name, error, tolerance) it checked."""
    import jax
    import jax.numpy as jnp

    from poccala_tpu.ops.gmm_score import gmm_log_scores
    from poccala_tpu.train import accumulators as acc
    from poccala_tpu.train import alignment as align
    from tests import oracles
    from tests.test_accumulators import oracle_stats

    emit = state_num - 2
    default_prec = str(jax.config.jax_default_matmul_precision)
    dot_default = f"DEFAULT (process default {default_prec})"
    results = []

    def rec(name, err, tol, precision):
        check(name, err, tol, precision)
        results.append((name, err, tol))

    stats, logliks = acc.batch_stats(
        bank, jnp.asarray(labels), jnp.asarray(label_lens),
        jnp.asarray(feats), jnp.asarray(t_masks), state_num, max_label_len,
        count_final_exit=False)         # the oracle replicates the reference
    vit_scores, label_pos = align.align_batch(
        bank, jnp.asarray(labels), jnp.asarray(label_lens),
        jnp.asarray(feats), jnp.asarray(t_masks), state_num, max_label_len)
    state_scores = np.asarray(gmm_log_scores(
        jnp.asarray(feats.reshape(-1, feats.shape[-1])), bank.means,
        bank.log_var, bank.log_w)).reshape(feats.shape[:2] + (-1,))
    logliks = np.asarray(logliks)
    vit_scores = np.asarray(vit_scores)
    label_pos = np.asarray(label_pos)

    names = ("occ", "c", "cx", "cxx", "trans", "trans_den")
    want = {k: 0.0 for k in names}
    sc_err = ll_err = vit_err = 0.0
    flips = frames = 0
    for i in range(len(feats)):
        t = int(t_masks[i].sum())
        label = [int(u) for u in labels[i, : label_lens[i]]]
        x = np.asarray(feats[i, :t], np.float64)
        o = oracle_stats(bank, label, x, state_num)
        for k in names:
            want[k] = want[k] + o[k]
        sen = [u * emit + e for u in label for e in range(emit)]
        sc_err = max(sc_err, rel_err(state_scores[i, :t][:, sen],
                                     o["scores"]))
        ll_err = max(ll_err, rel_err(logliks[i], o["loglik"]))
        v_score, v_path = oracles.viterbi_oracle(o["A"], o["prob"], o["pi"])
        n_s = o["A"].shape[0]
        emitting = (v_path >= 1) & (v_path < n_s - 1)
        want_pos = np.where(emitting, (v_path - 1) // emit, -1)
        flips += int(np.sum(want_pos != label_pos[i, :t]))
        frames += t
        vit_err = max(vit_err, rel_err(vit_scores[i], v_score))
    rec("GMM state scores", sc_err, TOL["scores"], "HIGHEST (f32)")
    rec("forward log-likelihood", ll_err, TOL["loglik"],
        "HIGHEST scoring, f32 DP")
    for k in names:
        prec = (f"einsum {dot_default}" if k in ("cx", "cxx")
                else "f32 reductions")
        rec(f"BW statistic {k}", rel_err(getattr(stats, k), want[k]),
            TOL["bw"], prec)
    mean_err, var_err = _mstep_errors(bank, stats, want)
    rec("M-step means", mean_err, TOL["mstep"],
        f"from cx via einsum {dot_default}")
    rec("M-step variances", var_err, TOL["mstep"],
        f"from cx, cxx via einsum {dot_default}")
    rec("Viterbi alignment flips (share)", flips / max(frames, 1),
        TOL["align_flips"], "HIGHEST scoring, f32 DP")
    rec("Viterbi score", vit_err, TOL["viterbi"], "HIGHEST scoring")

    if wav_signal is not None:
        from poccala_tpu.config import FrontendConfig
        from poccala_tpu.ops.frontend import Frontend

        fe = Frontend(FrontendConfig(reference_quirks=True))
        got, mask = fe.mfcc(wav_signal)
        got = np.asarray(got)[np.asarray(mask)]
        want_f = oracles.mfcc_quirk(np.asarray(wav_signal, np.float64),
                                    log_eps=1e-10)
        err = float(np.max(np.abs(got - want_f)))
        rec("MFCC+D+DD features (abs)", err, TOL["features"],
            "HIGHEST (DFT, mel, DCT and delta matmuls)")
    return results


def precision_probe(frames, seed: int = 0):
    """What a default-precision f32 contraction does on this device, at
    the shapes and magnitudes of the training path's unpinned sites:
    each pattern in DEFAULT and in HIGHEST against float64.  Printed,
    not gated: the oracle bars above gate what these feed."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    x = np.asarray(frames, np.float32)                  # [F, D] features
    f = len(x)
    lg = rng.normal(size=(f, 8)) * 3
    post = np.exp(lg - lg.max(1, keepdims=True))
    post = (post / post.sum(1, keepdims=True)).astype(np.float32)
    x64, p64 = x.astype(np.float64), post.astype(np.float64)

    def moments(prec):
        g, xx = jnp.asarray(post), jnp.asarray(x)
        nk = g.sum(0)[:, None]
        m = jnp.dot(g.T, xx, precision=prec) / nk
        sq = jnp.dot(g.T, xx * xx, precision=prec) / nk
        return np.asarray(m, np.float64), np.asarray(sq - m * m, np.float64)

    nk = p64.sum(0)[:, None]
    m_ref = p64.T @ x64 / nk
    v_ref = p64.T @ (x64 * x64) / nk - m_ref ** 2
    cen = x[rng.integers(0, f, size=8)]

    def dists(prec):
        d = (jnp.sum(jnp.asarray(x) ** 2, -1, keepdims=True)
             - 2 * jnp.dot(jnp.asarray(x), jnp.asarray(cen).T, precision=prec)
             + jnp.sum(jnp.asarray(cen) ** 2, -1)[None])
        return np.asarray(jnp.argmin(d, -1))

    d_ref = np.argmin(((x64[:, None] - cen[None].astype(np.float64)) ** 2)
                      .sum(-1), -1)
    for prec in (jax.lax.Precision.DEFAULT, jax.lax.Precision.HIGHEST):
        m, v = moments(prec)
        log(f"  probe {prec.name:<8s} posterior-weighted means (em.py, "
            f"accumulators, smem): {rel_err(m, m_ref):.2e} of max|mean|; "
            f"variance E[x²]-μ² {np.max(np.abs(v - v_ref) / v_ref):.2e} "
            f"of each variance; k-means assignments changed "
            f"{int(np.sum(dists(prec) != d_ref))}/{f}")


def _mstep_errors(bank, stats, want, min_occ: float = 2.0):
    """Device M-step (``accumulators.apply_update``) against the same
    update in float64 from the oracle's statistics, on the mixtures
    with at least ``min_occ`` frames of occupancy; errors are measured
    in units of E[x²] + μ_old², the size of the terms the variance
    update cancels."""
    from poccala_tpu.train import accumulators as acc

    new = acc.apply_update(bank, stats)
    c = want["c"][..., None]
    mu = np.asarray(bank.means, np.float64)
    mean_ref = want["cx"] / np.maximum(c, 1e-30)
    var_ref = (want["cxx"] - 2 * mu * want["cx"] + mu * mu * c) / \
        np.maximum(c, 1e-30)
    ex2 = want["cxx"] / np.maximum(c, 1e-30)
    ok = (c > min_occ) & (var_ref > 1e-6)   # above the update's floor
    if not ok.any():
        return 0.0, 0.0
    scale = np.maximum(ex2 + mu * mu, 1e-30)   # the cancelling terms
    d_mean = np.abs(np.asarray(new.means, np.float64) - mean_ref)
    d_var = np.abs(np.exp(np.asarray(new.log_var, np.float64)) - var_ref)
    return (float(np.max(d_mean[ok] / np.sqrt(scale[ok]))),
            float(np.max(d_var[ok] / scale[ok])))


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------

def phase_device(rehearse: bool, four: bool):
    import jax

    from poccala_tpu.utils.compile_cache import enable_compile_cache

    devs = jax.devices()
    plat = devs[0].platform
    if plat != "gpu" and not rehearse:
        log(f"no GPU: JAX found {plat!r} devices")
        raise SystemExit(2)
    want = 4 if four else 1
    if len(devs) < want:
        log(f"needs {want} devices, JAX found {len(devs)}")
        raise SystemExit(2)
    cache = enable_compile_cache()
    log(f"platform {plat}, device_kind {devs[0].device_kind!r}, "
        f"{len(devs)} device(s), jax {jax.__version__}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {cache}")
    if plat == "gpu":
        log(f"card: {card_line()}")
    return devs


def phase_train(work: str, sz: Sizes, seed: int):
    from poccala_tpu import cli

    words, dat = xif_words()
    audio, label, _ = make_corpus(os.path.join(work, "train"), words,
                                  sz.n_train, seed, sz.words_per_utt)
    log(f"  corpus: {sz.n_train} utterances, {len(words)}-word vocabulary")
    base = train_overrides(audio, label, sz, seed)
    ck = os.path.join(work, "ckpt")
    tr2 = cli.main(base + ["train", "--mode", "2",
                           "--epochs", str(sz.bw_epochs),
                           "--checkpoint", ck])
    lls = [h["loglik"] for h in tr2.history]
    log(f"  embedded BW log-likelihoods: {lls}")
    assert np.all(np.isfinite(lls)), lls
    for a, b in zip(lls, lls[1:]):
        assert b >= a - 1e-6 * abs(a), f"log-likelihood fell: {lls}"
    tr1 = cli.main(base + ["train", "--mode", "1",
                           "--epochs", str(sz.bw_epochs + 1), "--resume",
                           "--checkpoint", ck])
    ll1 = [h["loglik"] for h in tr1.history]
    log(f"  realignment round log-likelihood: {ll1}")
    assert len(ll1) == 1 and np.isfinite(ll1[0]), ll1
    bank = tr1.export_bank()
    log(f"  bank: {bank.num_states} senones x {bank.max_mix} mix x "
        f"{bank.dim} dim")
    return words, dat, base, ck, bank


def phase_oracle(base, bank, sz: Sizes):
    from poccala_tpu.io import wav as wav_io
    from poccala_tpu.io.corpus import Corpus

    cfg, inv = config_of(base)
    corpus = Corpus(cfg, inv)
    batch = next(iter(corpus.batches()))
    k = sz.oracle_utts
    data, _ = wav_io.load_wav(corpus.pairs[0][0])
    sig = wav_io.preprocess_signal(data, drop_zeros=True)
    oracle_check(bank, batch.feats[:k], batch.t_masks[:k],
                 batch.labels[:k], batch.label_lens[:k],
                 cfg.model.state_num, cfg.train.max_label_len,
                 wav_signal=sig)
    precision_probe(batch.feats[:k][batch.t_masks[:k]])


def phase_checkpoint(ck, bank):
    from poccala_tpu.train import checkpoint as ckpt

    loaded, manifest = ckpt.load_checkpoint(ck)
    assert manifest["format"] == "npz", manifest
    for f in ("means", "log_var", "log_w", "log_A", "log_pi",
              "mix_counts", "senone_map"):
        a, b = np.asarray(getattr(bank, f)), np.asarray(getattr(loaded, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    log(f"  {ck}: bit-identical to the trained bank (round "
        f"{manifest['round']}, mode {manifest['mode']})")


def _run_cli(argv):
    from poccala_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{")]


def phase_decode(work, words, dat, base, ck, bank, sz: Sizes, seed: int):
    from poccala_tpu import cli
    from poccala_tpu.decoder.beam import BeamDecoder
    from poccala_tpu.decoder.device import DeviceBeamDecoder
    from poccala_tpu.eval import wer
    from poccala_tpu.lexicon import FlatLexicon, PronunciationLexicon
    from poccala_tpu.ops.frontend import Frontend

    audio, _, transcripts = make_corpus(os.path.join(work, "test"), words,
                                        sz.n_test, seed + 1,
                                        sz.words_per_utt)
    wavs = [os.path.join(audio, name + ".wav") for name, _ in transcripts]
    refs = [list(w) for _, w in transcripts]
    with open(os.path.join(work, "words.txt"), "w") as f:
        f.write("\n".join(words) + "\n")
    with open(os.path.join(work, "toneless.dat"), "w") as f:
        f.write(dat)
    lex_path = os.path.join(work, "lexicon.pkl")
    cli.main(["build-lexicon", "--words", os.path.join(work, "words.txt"),
              "--mandarin-dat", os.path.join(work, "toneless.dat"),
              "--out", lex_path])

    cfg, inv = config_of(base)
    lex = PronunciationLexicon()
    lex.load(lex_path)
    flat = FlatLexicon.from_tree(lex.lexicon, inv)
    log(f"  lexicon: built-in table, {len(words)} single-character words "
        f"(toneless readings on the XIF units), {flat.n_nodes} nodes")

    dev_out = _run_cli(base + ["decode", "--decoder", "device",
                               "--checkpoint", ck, "--lexicon", lex_path,
                               *wavs])
    dev_best = [tuple(r["nbest"][0]["words"]) if r["nbest"] else ()
                for r in dev_out]

    fe = Frontend(cfg.frontend)
    feats = [cli.wav_features(cfg, fe, p) for p in wavs]
    host = BeamDecoder(bank, flat, beam=1.0, max_tokens=sz.host_max_tokens,
                       candidate=len(flat.children(0)))
    t0 = time.perf_counter()
    host_best = []
    for x in feats:
        h = host.decode(x, return_nbest=1)
        host_best.append(h[0].words if h else ())
    log(f"  host oracle decode: {time.perf_counter() - t0:.1f} s")
    for i, (d, h) in enumerate(zip(dev_best, host_best)):
        log(f"  utt {i}: device {' '.join(d)} | host {' '.join(h)} | "
            f"ref {' '.join(refs[i])}")
    assert dev_best == host_best, "device 1-best differs from host oracle"
    res = wer(refs, [list(d) for d in dev_best])
    log(f"  device decode vs host oracle: {len(wavs)}/{len(wavs)} equal; "
        f"WER against the synthesis script {res.wer:.3f} (proxy)")

    list_path = os.path.join(work, "serve.list")
    with open(list_path, "w") as f:
        f.write("\n".join(wavs) + "\n")
    srv_out = _run_cli(base + ["serve", "--checkpoint", ck, "--lexicon",
                               lex_path, "--list", list_path,
                               "--batch-size", "4"])
    srv_best = [tuple(r["nbest"][0]["words"]) if r["nbest"] else ()
                for r in srv_out]
    assert srv_best == dev_best, (srv_best, dev_best)
    for a, b in zip(srv_out, dev_out):
        if a["nbest"]:
            assert np.isclose(a["nbest"][0]["score"],
                              b["nbest"][0]["score"], rtol=1e-4)
    log(f"  cli serve == cli decode on {len(wavs)} utterances")

    dec = DeviceBeamDecoder(bank, flat,
                            normalizer=cfg.model.gaussian_normalizer,
                            score_dtype=cfg.model.score_dtype)
    n = np.asarray([len(x) for x in feats], np.int32)
    chunk = 25
    cap = int(-(-n.max() // chunk) * chunk)
    batch = np.zeros((len(feats), cap, feats[0].shape[1]), np.float32)
    for i, x in enumerate(feats):
        batch[i, : len(x)] = x
    one_shot = dec.decode_batch(batch, n)
    st = dec.stream_init(batch=len(feats), max_frames=cap)
    for lo in range(0, cap, chunk):
        valid = np.clip(n - lo, 0, chunk).astype(np.int32)
        st = dec.stream_feed(st, batch[:, lo: lo + chunk], n_valid=valid)
    streamed = dec.stream_result(st)
    for a, b, d in zip(streamed, one_shot, dev_best):
        assert a[0].words == b[0].words == d, (a, b, d)
        assert np.isclose(a[0].score, b[0].score, rtol=1e-5), (a, b)
    log(f"  streaming ({chunk}-frame chunks) == one-shot on "
        f"{len(feats)} utterances")


def random_bank(units: int, mix: int, dim: int, seed: int):
    """A bank with distinct senones: random means, variances and
    mixture weights drawn from ``seed``."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from poccala_tpu.config import ModelConfig
    from poccala_tpu.models import senone_bank as sb

    cfg = ModelConfig(state_num=5, mix_level=mix, max_mix_level=mix)
    bank = sb.create_bank(units, cfg, dim, key=jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    s = bank.num_states
    w = rng.dirichlet(np.ones(mix), size=s).astype(np.float32)
    return dataclasses.replace(
        bank,
        means=jnp.asarray(rng.normal(size=(s, mix, dim)).astype(np.float32)
                          * 3),
        log_var=jnp.asarray(rng.uniform(-1.0, 0.5, size=(s, mix, dim))
                            .astype(np.float32)),
        log_w=jnp.asarray(np.log(w)))


def frames_near(bank, labels, lens, t, seed: int):
    """Frames drawn around the means of each label's senones, in order."""
    rng = np.random.default_rng(seed)
    means = np.asarray(bank.means)
    smap = np.asarray(bank.senone_map)
    emit = smap.shape[1]
    b, d = len(labels), means.shape[-1]
    xs = np.zeros((b, t, d), np.float32)
    for i in range(b):
        sen = [int(smap[u, e]) for u in labels[i, : lens[i]]
               for e in range(emit)]
        idx = np.minimum(np.arange(t) * len(sen) // t, len(sen) - 1)
        comp = rng.integers(0, means.shape[1], size=t)
        xs[i] = means[np.asarray(sen)[idx], comp] + rng.normal(size=(t, d))
    return xs


def phase_four(work: str, sz: Sizes, seed: int):
    import jax
    import jax.numpy as jnp

    from poccala_tpu.decoder.device import DeviceBeamDecoder
    from poccala_tpu.io.corpus import UnitInventory
    from poccala_tpu.lexicon import FlatLexicon, PinYin, PronunciationLexicon
    from poccala_tpu.lexicon.builtin_table import BUILTIN_PINYIN
    from poccala_tpu.parallel import decode as pdecode
    from poccala_tpu.parallel import mesh as pmesh
    from poccala_tpu.train import accumulators as acc
    from poccala_tpu.train import checkpoint as ckpt

    devs = jax.devices()[:4]
    rng = np.random.default_rng(seed)

    with phase("state-sharded train step, (data=2, state=2) vs one card"):
        bank = random_bank(sz.c3_units, sz.c3_mix, 39, seed)
        log(f"  bank: {bank.num_states} senones x {bank.max_mix} mix x "
            f"{bank.dim} dim")
        b, t, max_l = sz.c3_batch, sz.c3_frames, sz.c3_labels
        labels = rng.integers(0, sz.c3_units, size=(b, max_l)).astype(
            np.int32)
        lens = rng.integers(max_l // 2, max_l + 1, size=b).astype(np.int32)
        xs = frames_near(bank, labels, lens, t, seed)
        masks = np.ones((b, t), bool)
        padded, s_orig = pmesh.pad_bank_states(bank, 2)

        mesh = pmesh.make_mesh(data_axis=2, state_axis=2, devices=devs)
        step = pmesh.make_state_sharded_train_step(mesh, 5, max_l)
        new_s, ll_s = step(pmesh.shard_bank_states(padded, mesh),
                           jnp.asarray(labels), jnp.asarray(lens),
                           jnp.asarray(xs), jnp.asarray(masks))

        @jax.jit
        def one_card(bank, labels, lens, xs, masks):
            stats, _ = acc.batch_stats(bank, labels, lens, xs, masks, 5,
                                       max_l)
            return acc.apply_update(bank, stats), stats.loglik

        one = jax.device_put(padded, devs[0])
        new_1, ll_1 = one_card(one, *(jax.device_put(jnp.asarray(a),
                                                     devs[0])
                                      for a in (labels, lens, xs, masks)))
        shard_s = new_s.means.addressable_shards[0].data.shape[0]
        assert shard_s * 2 == new_s.means.shape[0], shard_s
        check("loglik, sharded vs one card", rel_err(ll_s, ll_1), 1e-5,
              "f32")
        for f in ("means", "log_var", "log_w", "log_A"):
            check(f"{f}, sharded vs one card",
                  rel_err(getattr(new_s, f), getattr(new_1, f)), 1e-4,
                  "f32")
        path = os.path.join(work, "sharded_ckpt")
        ckpt.save_checkpoint(path, pmesh.unpad_bank_states(new_s, s_orig),
                             {"round": 1})
        loaded, man = ckpt.load_checkpoint(path)
        assert man["format"] == "npz", man
        assert "orbax" not in sys.modules, "orbax was imported"
        assert np.array_equal(np.asarray(loaded.means),
                              np.asarray(new_s.means)[:s_orig])
        log("  sharded bank saved and loaded as npz, orbax never imported")

    with phase("sharded decode (data=4) vs one card"):
        inv = UnitInventory.standard("XIF_tone")
        lex = PronunciationLexicon()
        lex.generate(list(BUILTIN_PINYIN), PinYin())
        flat = FlatLexicon.from_tree(lex.lexicon, inv)
        bank = random_bank(sz.dec_units, sz.dec_mix, 39, seed + 1)
        b = sz.dec_batch
        words = rng.integers(1, flat.n_nodes, size=(b, 6))
        labels = np.asarray(flat.node_units)[words].reshape(b, -1)
        lens = np.full((b,), labels.shape[1], np.int32)
        xs = frames_near(bank, labels, lens, sz.c3_frames, seed + 1)
        n = np.full((b,), sz.c3_frames, np.int32)
        dec = DeviceBeamDecoder(bank, flat)
        mesh4 = pmesh.make_mesh(data_axis=4, state_axis=1, devices=devs)
        sharded = pdecode.decode_sharded(dec, xs, n, mesh4)
        single = dec.decode_batch(xs, n)
        for a, c in zip(sharded, single):
            assert a[0].words == c[0].words, (a, c)
            assert np.isclose(a[0].score, c[0].score, rtol=1e-5), (a, c)
        log(f"  {b} utterances, {flat.n_nodes}-node built-in lexicon: "
            f"sharded 1-best == one-card 1-best")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-device path")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on any backend; no result line")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sz = TINY if args.rehearse else FULL

    t0 = time.perf_counter()
    with phase("device"):
        devs = phase_device(args.rehearse, args.four)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    if args.four:
        phase_four(work, sz, args.seed)
    else:
        with phase("train (cli train --mode 2, then --mode 1)"):
            words, dat, base, ck, bank = phase_train(work, sz, args.seed)
        with phase("oracle comparison on the device"):
            phase_oracle(base, bank, sz)
        with phase("checkpoint"):
            phase_checkpoint(ck, bank)
        with phase("decode, serve, stream"):
            phase_decode(work, words, dat, base, ck, bank, sz, args.seed)
    shutil.rmtree(work, ignore_errors=True)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    if args.rehearse:
        log("rehearsal passed (no result line)")
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
