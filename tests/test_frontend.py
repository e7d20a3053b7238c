"""Frontend (MFCC + VAD) tests against the reference-semantics oracle."""

import numpy as np
import pytest

from poccala_tpu.config import FrontendConfig
from poccala_tpu.io import wav
from poccala_tpu.ops import vad as vad_ops
from poccala_tpu.ops.frontend import Frontend, num_frames

from . import oracles


def synth_speechlike(n, rate=16000, seed=0):
    """Synthetic speech-like signal: silence + modulated harmonics + silence."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / rate
    sig = np.zeros(n)
    third = n // 3
    voiced = (
        3000 * np.sin(2 * np.pi * 220 * t[third: 2 * third])
        + 1500 * np.sin(2 * np.pi * 440 * t[third: 2 * third])
        + 200 * rng.normal(size=third)
    )
    sig[third: 2 * third] = voiced
    sig += 20 * rng.normal(size=n)
    return sig.astype(np.float32)


class TestWavIO:
    def test_roundtrip(self, tmp_path, rng):
        sig = (rng.normal(size=4000) * 1000).astype(np.int16)
        p = str(tmp_path / "x.wav")
        wav.write_wav(p, sig, 16000)
        out, rate = wav.load_wav(p)
        assert rate == 16000
        assert np.array_equal(out, sig)

    def test_stereo_max_merge_and_zero_drop(self):
        """AudioProcessing.py:167-176 semantics."""
        stereo = np.array([[1, 5], [0, 0], [-3, -7], [2, 1]], dtype=np.int16)
        mono = wav.preprocess_signal(stereo, drop_zeros=True)
        assert np.array_equal(mono, np.array([5, -3, 2], dtype=np.float32))
        mono2 = wav.preprocess_signal(stereo, drop_zeros=False)
        assert np.array_equal(mono2, np.array([5, 0, -3, 2], dtype=np.float32))


class TestMfccParity:
    def test_quirks_mode_matches_reference_oracle(self):
        """Full-pipeline parity vs the reference numerics
        (AudioProcessing.py:416-448) on an unpadded utterance."""
        sig = synth_speechlike(16000)  # 1 s
        cfg = FrontendConfig(reference_quirks=True)
        fe = Frontend(cfg)
        feats, mask = fe.mfcc(sig)
        assert bool(mask.all())
        want = oracles.mfcc_quirk(sig.astype(np.float64), log_eps=1e-10)
        got = np.asarray(feats)
        assert got.shape == want.shape == (num_frames(16000, 400, 200), 39)
        # fp32 device pipeline vs fp64 oracle over an FFT + 2 matmuls
        assert np.allclose(got, want, rtol=2e-3, atol=2e-3)

    def test_padding_invariance(self):
        """Padded batch entries must produce identical features for the
        valid region (mask discipline, SURVEY.md §7 hard part (a))."""
        sig = synth_speechlike(12000, seed=1)
        cfg = FrontendConfig(reference_quirks=True)
        fe = Frontend(cfg)
        feats_a, mask_a = fe.mfcc(sig)
        padded = np.zeros(20000, dtype=np.float32)
        padded[:12000] = sig
        feats_b, mask_b = fe.mfcc(padded, n_samples=12000)
        ta = int(mask_a.sum())
        assert int(mask_b.sum()) == ta
        assert np.allclose(
            np.asarray(feats_a)[:ta], np.asarray(feats_b)[:ta], rtol=1e-4, atol=1e-4
        )

    def test_batch_matches_single(self):
        cfg = FrontendConfig()
        fe = Frontend(cfg)
        sigs = np.stack([synth_speechlike(16000, seed=s) for s in range(3)])
        n = np.array([16000, 16000, 16000])
        fb, mb = fe.mfcc_batch(sigs, n)
        f0, m0 = fe.mfcc(sigs[1])
        assert np.allclose(np.asarray(fb)[1], np.asarray(f0), atol=1e-5)

    def test_textbook_mode_shapes_and_c0(self):
        cfg = FrontendConfig(reference_quirks=False)
        fe = Frontend(cfg)
        sig = synth_speechlike(8000)
        feats, mask = fe.mfcc(sig)
        t = int(mask.sum())
        assert feats.shape[1] == 39
        # c0 is log power of the loud middle > quiet edges
        f = np.asarray(feats)
        assert f[t // 2, 0] > f[0, 0]


class TestVad:
    def test_matches_reference_oracle(self):
        sig = synth_speechlike(16000)
        cfg = FrontendConfig(reference_quirks=True)
        fe = Frontend(cfg)
        feats, mask = fe.mfcc(sig)
        got = np.asarray(vad_ops.vad_mask(feats, mask))
        want = oracles.vad_keep_mask(np.asarray(feats, dtype=np.float64))
        assert got.shape[0] == want.shape[0]
        # tolerance: threshold comparisons can flip on fp32/fp64 boundary
        assert np.mean(got == want) > 0.97

    def test_keeps_speech_drops_silence(self):
        sig = synth_speechlike(16000, seed=2)
        cfg = FrontendConfig()
        fe = Frontend(cfg)
        feats, mask = fe.mfcc(sig)
        keep = np.asarray(vad_ops.vad_mask(feats, mask))
        t = int(np.asarray(mask).sum())
        # middle third is voiced; expect it mostly kept
        mid = keep[t // 3: 2 * t // 3]
        assert mid.mean() > 0.8
        # something must have been dropped (silence exists)
        assert keep[:t].mean() < 0.95

    def test_short_utterance_passthrough(self):
        cfg = FrontendConfig()
        fe = Frontend(cfg)
        sig = synth_speechlike(3000, seed=3)  # ~14 frames < 33
        feats, mask = fe.mfcc(sig)
        keep = np.asarray(vad_ops.vad_mask(feats, mask))
        assert np.array_equal(keep, np.asarray(mask))

    def test_apply_mask_packs(self):
        feats = np.arange(20, dtype=np.float32).reshape(10, 2)
        mask = np.array([1, 0, 1, 1, 0, 0, 1, 0, 0, 0], dtype=bool)
        packed, n = vad_ops.apply_mask(feats, mask, max_frames=6)
        assert n == 4
        assert np.array_equal(packed[:4], feats[mask])
        assert np.all(packed[4:] == 0)


class TestCmvn:
    """Flag-gated per-utterance cepstral mean/variance normalization
    (frontend.cmvn / cmvn_var; the reference pipeline has none,
    ``AudioProcessing.py:416-448``)."""

    def test_masked_moments(self):
        """Valid-frame cepstra are zero-mean (unit-variance with
        cmvn_var), padding stays zeroed, stats ignore padding."""
        sig = synth_speechlike(12000, seed=3)
        fe = Frontend(FrontendConfig(cmvn=True, cmvn_var=True))
        padded = np.zeros(20000, np.float32)
        padded[:12000] = sig
        feats, mask = fe.mfcc(padded, n_samples=12000)
        f = np.asarray(feats)
        m = np.asarray(mask)
        t = int(m.sum())
        cep = f[:t, :13]
        assert np.allclose(cep.mean(axis=0), 0.0, atol=1e-4)
        assert np.allclose(cep.var(axis=0), 1.0, atol=1e-2)
        assert np.allclose(f[t:], 0.0)

    def test_gain_invariance(self):
        """A constant channel gain shifts log-spectra by a constant per
        coefficient; CMVN must cancel it (the property that makes it
        the standard channel/noise remedy)."""
        sig = synth_speechlike(12000, seed=4) + 50.0  # keep bins off the floor
        fe = Frontend(FrontendConfig(cmvn=True))
        f1, m1 = fe.mfcc(sig)
        f2, m2 = fe.mfcc(3.0 * sig)
        t = int(np.asarray(m1).sum())
        assert np.allclose(np.asarray(f1)[:t], np.asarray(f2)[:t],
                           atol=2e-2)
        # without CMVN the same pair differs materially (c0 shifts by
        # log gain)
        fe0 = Frontend(FrontendConfig())
        g1, _ = fe0.mfcc(sig)
        g2, _ = fe0.mfcc(3.0 * sig)
        assert abs(np.asarray(g1)[t // 2, 0]
                   - np.asarray(g2)[t // 2, 0]) > 0.5

    def test_deltas_ride_normalized_stream(self):
        """Δ columns are the regression of the *normalized* cepstra."""
        sig = synth_speechlike(12000, seed=5)
        fe = Frontend(FrontendConfig(cmvn=True))
        feats, mask = fe.mfcc(sig)
        t = int(np.asarray(mask).sum())
        f = np.asarray(feats)[:t]
        # oracle: ±2 regression deltas of the normalized static part
        cep = f[:, :13]
        denom = 2 * (1 + 4)
        pad = np.pad(cep, ((2, 2), (0, 0)), mode="edge")
        want = sum(k * pad[2 + k: 2 + k + t] for k in (-2, -1, 1, 2)) / denom
        assert np.allclose(f[:, 13:26], want, atol=1e-4)

    def test_pitch_column_excluded(self):
        """CMVN leaves the voiced/unvoiced pitch sentinel untouched."""
        sig = synth_speechlike(12000, seed=6)
        fa = Frontend(FrontendConfig(pitch=True))
        fb = Frontend(FrontendConfig(pitch=True, cmvn=True))
        f1, m = fa.mfcc(sig)
        f2, _ = fb.mfcc(sig)
        t = int(np.asarray(m).sum())
        assert np.allclose(np.asarray(f1)[:t, 13], np.asarray(f2)[:t, 13])
