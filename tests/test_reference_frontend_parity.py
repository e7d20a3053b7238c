"""Frontend parity against the *actual reference code*.

``StatisticalModel/AudioProcessing.py`` imports pyaudio and pylab at
module scope (for playback/plotting only), which makes it unimportable
in this environment.  The MFCC/VAD math itself is pure NumPy, so these
tests import the real module with inert stand-ins for those two
device/plot modules and drive the reference's own ``MFCC.mfcc`` /
``VAD.mfcc`` methods — closing the oracle-vs-oracle gap where
``tests/oracles.py`` (a reimplementation) could self-confirm a
transcription error.

Three-way parity per stage: reference code ↔ oracles.py (fp64,
near-exact) and reference code ↔ device pipeline (fp32 tolerance).

Skipped automatically when the reference tree is not present.
"""

import os
import sys
import types

import numpy as np
import pytest

from poccala_tpu.config import FrontendConfig
from poccala_tpu.ops import vad as vad_ops
from poccala_tpu.ops.frontend import Frontend

from . import oracles
from .test_frontend import synth_speechlike

REF = "/root/reference"
pytestmark = pytest.mark.skipif(
    not os.path.isfile(os.path.join(REF, "StatisticalModel",
                                    "AudioProcessing.py")),
    reason="reference tree not available",
)


def _load_reference_audio():
    """Import the reference AudioProcessing class with stub pyaudio/pylab.

    The stubs are removed from ``sys.modules`` afterwards so the rest of
    the suite (e.g. the pyaudio-absence test in test_leaf_components)
    still sees the true environment; the imported module keeps its own
    references to the stub objects.
    """
    mod_name = "StatisticalModel.AudioProcessing"
    if mod_name in sys.modules:
        return sys.modules[mod_name].AudioProcessing
    injected = []
    for name in ("pyaudio", "pylab"):
        if name not in sys.modules:
            stub = types.ModuleType(name)
            if name == "pyaudio":
                stub.PyAudio = lambda: None
                stub.paInt16 = 8
            sys.modules[name] = stub
            injected.append(name)
    if REF not in sys.path:
        sys.path.insert(0, REF)
    try:
        from StatisticalModel import AudioProcessing as ap  # noqa: E402
    finally:
        for name in injected:
            sys.modules.pop(name, None)
    return ap.AudioProcessing


class _FakeWav:
    """Just enough of wave.Wave_read for MFCC.mfcc's params[2] access."""

    def __init__(self, rate):
        self._rate = rate

    def getparams(self):
        return (1, 2, self._rate, 0, "NONE", "not compressed")


def _reference_mfcc(signal, rate=16000, vec_num=13):
    """Run the reference's own MFCC.mfcc (AudioProcessing.py:416-448)."""
    AudioProcessing = _load_reference_audio()
    m = AudioProcessing.MFCC(vec_num=vec_num)
    m._MFCC__wav = _FakeWav(rate)
    m._MFCC__wdata = np.asarray(signal)
    return m.mfcc(d1=True, d2=True)


def _reference_vad_frames(feats, simple_size=16):
    """Run the reference's own VAD.mfcc (AudioProcessing.py:538-543)."""
    AudioProcessing = _load_reference_audio()
    v = AudioProcessing.VAD(simple_size=simple_size)
    v.init_mfcc(np.asarray(feats))
    return v.mfcc()


def _nonzero_int16_signal(n, seed=0):
    sig = synth_speechlike(n, seed=seed)
    sig = np.round(sig).astype(np.int16)
    # the reference deletes zero samples at load (AudioProcessing.py:176);
    # we bypass init_audio, so feed a zero-free signal for a clean compare
    sig[sig == 0] = 1
    return sig


class TestReferenceMfcc:
    def test_oracle_matches_reference_code(self):
        """tests/oracles.py vs the executed reference pipeline: fp64
        near-exact (only float association order differs in the DCT)."""
        sig = _nonzero_int16_signal(16000)
        want = _reference_mfcc(sig)
        got = oracles.mfcc_quirk(sig.astype(np.float64))
        assert got.shape == want.shape
        assert np.allclose(got, want, rtol=1e-9, atol=1e-9)

    def test_device_frontend_matches_reference_code(self):
        """The jitted device pipeline vs the executed reference pipeline."""
        sig = _nonzero_int16_signal(16000, seed=1)
        want = _reference_mfcc(sig)
        fe = Frontend(FrontendConfig(reference_quirks=True))
        feats, mask = fe.mfcc(sig.astype(np.float32))
        assert bool(np.asarray(mask).all())
        got = np.asarray(feats)
        assert got.shape == want.shape
        # fp32 device pipeline (FFT + 2 matmuls) vs fp64 reference
        assert np.allclose(got, want, rtol=2e-3, atol=2e-3)

    def test_stagewise_parity(self):
        """Each quirk stage in oracles.py against the reference's own
        staticmethod, so a failure localizes to one stage."""
        AudioProcessing = _load_reference_audio()
        M = AudioProcessing.MFCC
        sig = _nonzero_int16_signal(8000, seed=2).astype(np.float64)

        pe_ref = M.pre_emphasis(sig)
        assert np.allclose(oracles.pre_emphasis(sig), pe_ref)

        fb_ref = M.frame_blocking(pe_ref, 16000)
        fb = oracles.frame_blocking(pe_ref, 16000)
        assert np.array_equal(fb, fb_ref)

        # hamming_window mutates in place — hand each its own copy
        win_ref = M.hamming_window(fb_ref.copy())
        win = oracles.hamming_window_quirk(fb.copy())
        assert np.allclose(win, win_ref)

        spec_ref = M.fft(win_ref, 512)
        spec = oracles.fft_mag(win, 512)
        assert np.allclose(spec, spec_ref)

        fbank_ref, energy_ref = M.mel_filter_bank(spec_ref, 16000, nfft=512)
        fbank, energy = oracles.mel_filter_bank_quirk(spec, 16000, nfft=512)
        assert np.allclose(fbank, fbank_ref)
        assert np.allclose(energy, energy_ref)

        dct_ref = M.dct(fbank_ref, rank=13)
        dct = oracles.dct_quirk(fbank, rank=13)
        assert np.allclose(dct, dct_ref, rtol=1e-9, atol=1e-9)

        d_ref = M.cal_delta(dct_ref)
        assert np.allclose(oracles.cal_delta(dct), d_ref)


class TestReferenceVad:
    def test_oracle_mask_matches_reference_code(self):
        """oracles.vad_keep_mask selects exactly the frames the
        reference's VAD.mfcc returns."""
        sig = _nonzero_int16_signal(16000, seed=3)
        feats = _reference_mfcc(sig)
        kept_ref = _reference_vad_frames(feats)
        mask = oracles.vad_keep_mask(feats)
        assert np.array_equal(feats[mask], kept_ref)

    def test_device_vad_matches_reference_code(self):
        sig = _nonzero_int16_signal(16000, seed=4)
        fe = Frontend(FrontendConfig(reference_quirks=True))
        feats, mask = fe.mfcc(sig.astype(np.float32))
        feats_np = np.asarray(feats, dtype=np.float64)
        kept_ref = _reference_vad_frames(feats_np)
        got = np.asarray(vad_ops.vad_mask(feats, mask))
        # threshold comparisons can flip on the fp32/fp64 boundary
        agree = np.mean(got == oracles.vad_keep_mask(feats_np))
        assert agree > 0.97
        assert abs(int(got.sum()) - len(kept_ref)) <= max(2, int(0.03 * len(got)))
