"""The GPU path's CPU-side pieces: the scoring route of both decoder
tiers, the compile-cache placement, and ``chip_smoke.py`` (its refusal
to run without a GPU and its oracle comparison at tiny width)."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from poccala_tpu.decoder.beam import BeamDecoder
from poccala_tpu.decoder.device import DeviceBeamDecoder
from poccala_tpu.io.corpus import UnitInventory
from poccala_tpu.lexicon import FlatLexicon, PinYin, PronunciationLexicon
from poccala_tpu.ops.gmm_score import gmm_log_scores
from poccala_tpu.utils import compile_cache

from .test_frontend import synth_speechlike
from .test_senone_topology import make_bank

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _decoders(rng, normalizer, score_dtype):
    units = ["n", "i3", "h", "ao3", "m", "a1"]
    _, bank = make_bank(rng, num_units=len(units), mix=2, max_mix=3, dim=13)
    lex = PronunciationLexicon()
    lex.generate(["你好", "马"], PinYin({"你": ["ni3"], "好": ["hao3"],
                                        "马": ["ma1"]}))
    flat = FlatLexicon.from_tree(lex.lexicon, UnitInventory(units))
    kw = dict(normalizer=normalizer, score_dtype=score_dtype)
    return bank, BeamDecoder(bank, flat, **kw), DeviceBeamDecoder(bank, flat,
                                                                  **kw)


@pytest.mark.parametrize("score_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("normalizer", ["textbook", "reference"])
def test_decoder_scoring_is_gmm_log_scores(rng, normalizer, score_dtype):
    """Both decoder tiers score through ``gmm_log_scores`` itself (no
    kernel of their own, no backend switch)."""
    bank, host, dev = _decoders(rng, normalizer, score_dtype)
    feats = (rng.normal(size=(2, 20, 13)) * 2).astype(np.float32)
    def score(x):
        return np.asarray(gmm_log_scores(
            jnp.asarray(x), bank.means, bank.log_var, bank.log_w,
            normalizer=normalizer, score_dtype=score_dtype))

    # the device tier scores the whole batch as one [B*T, D] block
    want = score(feats.reshape(-1, 13)).reshape(2, 20, -1)
    got_dev = np.asarray(dev._scores_in_graph(jnp.asarray(feats)))
    got_host = host._frame_scores(feats[0])
    assert got_dev.shape == want.shape
    np.testing.assert_allclose(got_dev, want, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got_host, score(feats[0]), rtol=1e-6,
                               atol=1e-4)


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.compile_cache_dir() == str(tmp_path)
    assert compile_cache.enable_compile_cache() == str(tmp_path)


def test_compile_cache_fixed_in_checkout(monkeypatch):
    """Without the variable the cache sits at one path inside the
    checkout, the same on every call."""
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    first = compile_cache.compile_cache_dir()
    assert first == compile_cache.compile_cache_dir()
    assert first == os.path.join(ROOT, ".jax_cache")


def test_chip_smoke_refuses_cpu():
    """Without a GPU the smoke test exits non-zero and prints no result
    line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_oracle_check_tiny(rng):
    """The smoke test's oracle comparison passes at tiny width on the
    CPU: E-step, M-step, alignment and features against the float64
    oracles."""
    import chip_smoke

    cfg, bank = make_bank(rng, num_units=4, mix=2, max_mix=2, dim=5)
    b, t, max_l = 3, 24, 4
    labels = rng.integers(0, 4, size=(b, max_l)).astype(np.int32)
    lens = np.asarray([4, 3, 2], np.int32)
    feats = chip_smoke.frames_near(bank, labels, lens, t, seed=1)
    masks = np.arange(t)[None, :] < np.asarray([24, 20, 16])[:, None]
    results = chip_smoke.oracle_check(
        bank, feats, masks, labels, lens, cfg.state_num, max_l,
        wav_signal=synth_speechlike(16000))
    names = [r[0] for r in results]
    assert "GMM state scores" in names and len(names) == 13
    assert all(err <= tol for _, err, tol in results)
