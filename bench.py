"""Benchmark: audio-seconds per second on one GPU for the full pipeline.

Measures the BASELINE.json metric — training (embedded Baum-Welch EM
E+M step) plus Viterbi forced alignment, including the MFCC frontend —
on synthetic Mandarin-shaped data at roughly BASELINE config 2 scale
(3 emitting states, 8-mixture 39-dim GMMs, the full XIF pinyin unit set,
batch-256 utterances).

The timed training iterations run inside one jitted ``lax.scan``, so
host dispatch between iterations is not measured; the run ends in
``block_until_ready``.

Prints the headline JSON line first:
    {"metric": "train_em_plus_viterbi_audio_throughput", ...}
then a second JSON line for the serving path — device-tier decode
(frontend + one jitted program: GMM scoring + dense graph-Viterbi scan
+ on-device n-best extraction), batch 256, over the lexicon built from
the repository's built-in hanzi table (``lexicon/builtin_table.py``) on
the XIF_tone units, a few hundred nodes (the line names it).  The
reference-scale table is not in the repository, so this decode line
measures a small vocabulary:
    {"metric": "decode_audio_throughput", ...}
Every line names the platform, device kind and count, and the card's
name and power limit.  The run fails on any backend other than a GPU,
and a failed phase fails the run.  vs_baseline is value / 100 — the
reference publishes no numbers (BASELINE.md), so the yardstick is its
north-star target of 100x real-time per chip.
"""

import json
import subprocess
import sys
import time

import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def device_fields() -> dict:
    """Platform, device kind and count as JAX reports them, plus the
    card's name and power limit (``nvidia-smi``)."""
    import jax

    dev = jax.devices()[0]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices()), "card": card}


def main():
    import jax

    from poccala_tpu.utils.compile_cache import enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        raise SystemExit(
            f"bench.py needs a GPU; JAX found {jax.devices()[0].platform}")
    log(f"compile cache: {enable_compile_cache()}")

    import jax.numpy as jnp

    from poccala_tpu.config import Config
    from poccala_tpu.io.corpus import UnitInventory
    from poccala_tpu.models import senone_bank as sb
    from poccala_tpu.ops.frontend import Frontend
    from poccala_tpu.train import accumulators as acc
    from poccala_tpu.train import alignment as align

    dev = device_fields()
    log(f"device: {dev}")

    # ---- BASELINE config-2-shaped workload
    cfg = Config()
    cfg.model.state_num = 5
    cfg.model.mix_level = 8
    cfg.model.max_mix_level = 8
    inv = UnitInventory.standard("XIF")  # 62 units
    num_units = len(inv)

    batch = 256
    utt_seconds = 4.0
    rate = cfg.frontend.sample_rate
    n_samples = int(utt_seconds * rate)
    max_label_len = 16
    state_num = cfg.model.state_num
    iters = 8

    rng = np.random.default_rng(0)
    signals = jnp.asarray(
        (rng.normal(size=(batch, n_samples)) * 2000).astype(np.float32))
    n_samp = jnp.asarray(np.full((batch,), n_samples, np.int64))
    labels = jnp.asarray(
        rng.integers(0, num_units, size=(batch, max_label_len)).astype(np.int32))
    lens = jnp.asarray(
        rng.integers(max_label_len // 2, max_label_len + 1,
                     size=(batch,)).astype(np.int32))

    fe = Frontend(cfg.frontend)
    bank = sb.create_bank(num_units, cfg.model, cfg.frontend.feat_dim,
                          key=jax.random.PRNGKey(0))
    log(f"bank: {bank.num_states} senones x {bank.max_mix} mix x {bank.dim} dim")

    def one_epoch(bank, _):
        """frontend -> embedded-BW E+M -> Viterbi alignment."""
        feats, masks = jax.vmap(fe._mfcc_impl)(signals, n_samp)
        stats, _ = acc.batch_stats(
            bank, labels, lens, feats, masks, state_num, max_label_len
        )
        new_bank = acc.apply_update(bank, stats)
        scores, label_pos = align.align_batch(
            new_bank, labels, lens, feats, masks, state_num, max_label_len
        )
        probe = stats.loglik + jnp.sum(scores) + jnp.sum(label_pos)
        return new_bank, probe

    @jax.jit
    def run(bank):
        new_bank, probes = jax.lax.scan(one_epoch, bank, None, length=iters)
        return new_bank, jnp.sum(probes)

    # ---- warmup (compile + one full execution)
    t0 = time.time()
    _, probe = run(bank)
    log(f"compile+run: {time.time()-t0:.1f}s probe={float(probe):.3e}")

    # ---- timed
    t0 = time.time()
    _, probe = jax.block_until_ready(run(bank))
    elapsed = time.time() - t0
    assert np.isfinite(float(probe)), probe

    audio_seconds = batch * utt_seconds * iters
    value = audio_seconds / elapsed
    log(f"{audio_seconds:.0f} audio-s in {elapsed:.2f}s")
    print(json.dumps({
        "metric": "train_em_plus_viterbi_audio_throughput",
        "value": round(value, 2),
        "unit": "audio-s/s",
        "vs_baseline": round(value / 100.0, 3),
        **dev,
    }), flush=True)

    bench_decode(cfg, fe, rng, dev)


def bench_decode(cfg, fe, rng, dev, batch=256, utt_seconds=4.0, calls=3):
    """Device-tier decode throughput (BASELINE north star: decode at
    >=100x real-time).  End-to-end per call: MFCC frontend -> one jitted
    program (GMM frame scoring + dense graph-Viterbi scan + on-device
    n-best extraction) over the built-in-table lexicon on the XIF_tone
    units -> host id->word mapping.  All host work and device dispatch
    are inside the timed region — this is the serving number, not a
    kernel number."""
    import jax
    import jax.numpy as jnp

    from poccala_tpu.decoder.device import DeviceBeamDecoder
    from poccala_tpu.io.corpus import UnitInventory
    from poccala_tpu.lexicon import FlatLexicon, PinYin, PronunciationLexicon
    from poccala_tpu.lexicon.builtin_table import BUILTIN_PINYIN
    from poccala_tpu.models import senone_bank as sb

    inv = UnitInventory.standard("XIF_tone")
    words = list(BUILTIN_PINYIN.keys())
    lex = PronunciationLexicon()
    lex.generate(words, PinYin())
    flat = FlatLexicon.from_tree(lex.lexicon, inv)
    bank = sb.create_bank(len(inv), cfg.model, cfg.frontend.feat_dim,
                          key=jax.random.PRNGKey(1))
    dec = DeviceBeamDecoder(bank, flat)
    log(f"decode: lexicon {flat.n_nodes} nodes / {len(words)} words, "
        f"bank {bank.num_states} senones")

    rate = cfg.frontend.sample_rate
    n_samples = int(utt_seconds * rate)
    signals = jnp.asarray(
        (rng.normal(size=(batch, n_samples)) * 2000).astype(np.float32))
    n_samp = jnp.asarray(np.full((batch,), n_samples, np.int64))

    mfcc = jax.jit(jax.vmap(fe._mfcc_impl))  # hoisted: re-wrapping per
    # call would retrace + re-lookup the executable every iteration

    def features():
        feats, masks = mfcc(signals, n_samp)
        # feats stay on device; the decode program consumes them directly
        return feats, np.asarray(masks.sum(axis=1), np.int32)

    # warmup: frontend + scoring + scan + finalize compile
    t0 = time.time()
    feats, n_frames = features()
    hyps = dec.decode_batch(feats, n_frames)
    log(f"decode compile+run: {time.time()-t0:.1f}s "
        f"({sum(len(h) for h in hyps)} hypotheses)")

    # timed, double-buffered: dispatch call k+1 before collecting call
    # k (the poccala_tpu.serve.DecodeService pattern) so host work and
    # the device program overlap; decode_collect's host fetch still
    # synchronizes every call's device work inside the timed region
    t0 = time.time()
    pending = None
    for _ in range(calls):
        feats, n_frames = features()
        handle = dec.decode_dispatch(feats, n_frames)
        if pending is not None:
            hyps = dec.decode_collect(pending)
        pending = handle
    hyps = dec.decode_collect(pending)
    elapsed = time.time() - t0
    assert all(len(h) >= 1 for h in hyps), "empty decode on some utterance"

    audio_seconds = batch * utt_seconds * calls
    value = audio_seconds / elapsed
    log(f"decode: {audio_seconds:.0f} audio-s in {elapsed:.2f}s")
    print(json.dumps({
        "metric": "decode_audio_throughput",
        "value": round(value, 2),
        "unit": "audio-s/s",
        "vs_baseline": round(value / 100.0, 3),
        "batch": batch,
        "lexicon": "built-in table, XIF_tone units",
        "lexicon_words": len(words),
        "lexicon_nodes": int(flat.n_nodes),
        **dev,
    }), flush=True)


if __name__ == "__main__":
    main()
