"""Native C++ batch WAV loader vs the Python reference path."""

import numpy as np
import pytest

from poccala_tpu import native
from poccala_tpu.io import wav as wav_io


@pytest.fixture(scope="module")
def wav_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(0)
    paths, signals = [], []
    for i, n in enumerate((1000, 4000, 2500)):
        sig = (rng.normal(size=n) * 3000).astype(np.int16)
        sig[::50] = 0  # sprinkle zeros for the drop path
        p = str(d / f"f{i}.wav")
        wav_io.write_wav(p, sig, 16000)
        paths.append(p)
        signals.append(sig)
    # a stereo file
    stereo = (rng.normal(size=(800, 2)) * 3000).astype(np.int16)
    import wave

    p = str(d / "stereo.wav")
    with wave.open(p, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(stereo.tobytes())
    paths.append(p)
    signals.append(stereo)
    return paths, signals


class TestNativeLoader:
    def test_builds(self):
        assert native.available(), "native toolchain expected in this image"

    def test_matches_python_loader(self, wav_files):
        paths, signals = wav_files
        out, lengths, rates = native.load_wav_batch(paths, max_samples=5000)
        assert (rates == 16000).all()
        for i, sig in enumerate(signals):
            want = wav_io.preprocess_signal(sig, drop_zeros=False)
            n = lengths[i]
            assert n == len(want)
            assert np.array_equal(out[i, :n], want)
            assert np.all(out[i, n:] == 0)

    def test_drop_zeros(self, wav_files):
        paths, signals = wav_files
        out, lengths, _ = native.load_wav_batch(
            paths[:3], max_samples=5000, drop_zeros=True
        )
        for i in range(3):
            want = wav_io.preprocess_signal(signals[i], drop_zeros=True)
            assert lengths[i] == len(want)
            assert np.array_equal(out[i, : lengths[i]], want)

    def test_truncation_and_errors(self, wav_files):
        paths, signals = wav_files
        out, lengths, _ = native.load_wav_batch(paths[:1], max_samples=100)
        assert lengths[0] == 100
        out, lengths, _ = native.load_wav_batch(
            ["/nonexistent/file.wav"], max_samples=100
        )
        assert lengths[0] == -1


class TestCorpusNativePath:
    def test_native_batches_match_python_batches(self, tmp_path):
        from poccala_tpu.config import Config
        from poccala_tpu.io import corpus as corpus_io

        inv = corpus_io.UnitInventory(["aa", "bb", "cc"])
        audio, label = corpus_io.generate_synthetic_corpus(
            str(tmp_path), inv, num_utts=7, seed=3)
        cfg = Config()
        cfg.paths.audio_file_path = audio
        cfg.paths.label_file_path = label
        cfg.train.load_line = 0
        cfg.train.batch_size = 4
        cfg.train.max_frames = 128
        cfg.train.max_label_len = 5
        corpus = corpus_io.Corpus(cfg, inv)
        nat = list(corpus.batches(use_native=True))
        py = list(corpus.batches(use_native=False))
        assert len(nat) == len(py) == 2
        for a, b in zip(nat, py):
            assert np.array_equal(a.labels, b.labels)
            assert np.array_equal(a.label_lens, b.label_lens)
            assert np.array_equal(a.t_masks, b.t_masks)
            assert np.allclose(a.feats, b.feats, atol=1e-4)


class TestNativeBuildKey:
    def test_library_keyed_on_source_hash(self):
        """The built library's name carries a hash of ``wavio.cpp``, so
        a library built from other source is never loaded."""
        import hashlib
        import os

        with open(os.path.join(os.path.dirname(native.__file__),
                               "wavio.cpp"), "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        path = native.lib_path()
        assert os.path.basename(path) == f"libpoccala_native_{digest}.so"
        assert native.available()
        assert os.path.exists(path)
