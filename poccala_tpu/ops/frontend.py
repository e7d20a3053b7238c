"""MFCC feature frontend as one fused, batched, jit-compiled pipeline.

Replaces the reference's per-stage Python/NumPy pipeline
(``StatisticalModel/AudioProcessing.py:183-448``): pre-emphasis →
framing → windowing → |rFFT| → mel filterbank (+frame energy) → DCT →
energy-c0 → Δ/ΔΔ.  The scalar triple-loop DCT (``AudioProcessing.py:364-369``)
and the per-frame window loop (``:243-245``) become matmuls; everything
else fuses into the surrounding elementwise graph.  Ragged utterance lengths are handled with padding + frame masks
instead of Python-list raggedness (SURVEY.md §7 "hard parts" (a)).

Reference-numerics quirks are flag-gated via ``FrontendConfig.reference_quirks``
(SURVEY.md §7 "hard parts" (b)); with the flag on, this pipeline matches
the reference bit-for-bit-tolerant on unpadded inputs:

* Hamming window applied across the *frame index* axis — each frame is
  scaled by one scalar ``0.54 - 0.46*cos(2πi/(T-1))`` where ``i`` is the
  frame number (``AudioProcessing.py:242-245``), not a per-sample taper.
* Mel filters are *ascending sawtooths*: the falling edge of the
  triangle is coded as a second rising ramp (``AudioProcessing.py:323-326``).
* DCT basis uses ``cos(π(2k-1)j/2M)`` with k starting at 0
  (``AudioProcessing.py:368``) instead of the DCT-II ``(2k+1)``.
* Frame energy is the sum of rFFT *magnitudes* (``AudioProcessing.py:338``),
  not the power.

With the flag off (default) the textbook forms are used.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from poccala_tpu.config import FrontendConfig

_LOG_EPS = 1e-10  # floor before log; the reference takes log(0) -> -inf


_PRECISION = {
    "highest": jax.lax.Precision.HIGHEST,   # 6-pass f32-exact
    "high": jax.lax.Precision.HIGH,         # bf16_3x
    "default": jax.lax.Precision.DEFAULT,   # one bf16 pass
}


def mel_of_hz(hz):
    """Mel(f) = 2595 * ln(1 + f/700) (``AudioProcessing.py:307-308``)."""
    return 2595.0 * np.log(1.0 + np.asarray(hz) / 700.0)


def hz_of_mel(mel):
    """Inverse mel scale (``AudioProcessing.py:310-311``)."""
    return 700.0 * (np.exp(np.asarray(mel) / 2595.0) - 1.0)


def mel_filterbank_matrix(cfg: FrontendConfig) -> np.ndarray:
    """Build the [nfft//2+1, num_filters] filterbank matrix.

    Reference construction: ``AudioProcessing.py:306-343`` — mel-spaced
    center bins via ``floor((nfft+1)/rate * hz)``, integer-truncated ramp
    starts, float bin-difference denominators.  ``reference_quirks``
    selects the ascending-sawtooth falling edge (``:325-326``); otherwise
    a proper descending edge is used.
    """
    high_hz = cfg.high_hz or cfg.sample_rate / 2
    mel = np.linspace(mel_of_hz(cfg.low_hz), mel_of_hz(high_hz), cfg.num_filters + 2)
    hz = hz_of_mel(mel)
    bins = np.floor((cfg.nfft + 1) / cfg.sample_rate * hz)  # float values
    n_bins = cfg.nfft // 2 + 1
    fbank = np.zeros((cfg.num_filters, n_bins))
    for i in range(cfg.num_filters):
        b0, b1, b2 = int(bins[i]), int(bins[i + 1]), int(bins[i + 2])
        for j in range(b0, b1):
            fbank[i, j] = (j - b0) / (bins[i + 1] - bins[i])
        for j in range(b1, min(b2, n_bins)):
            if cfg.reference_quirks:
                fbank[i, j] = (j - b1) / (bins[i + 2] - bins[i + 1])
            else:
                fbank[i, j] = (bins[i + 2] - j) / (bins[i + 2] - bins[i + 1])
    return fbank.T.astype(np.float32)  # [n_bins, num_filters]


def dct_matrix(cfg: FrontendConfig) -> np.ndarray:
    """[num_filters, dct_num] DCT basis.

    Reference: ``C[k, j] = (2/√M)·cos(π(2k-1)j/(2M))`` with k from 0
    (``AudioProcessing.py:361-368``); textbook DCT-II uses ``(2k+1)``.
    """
    m = cfg.num_filters
    k = np.arange(m)[:, None]
    j = np.arange(cfg.dct_num)[None, :]
    coeff = 2.0 / math.sqrt(m)
    if cfg.reference_quirks:
        basis = coeff * np.cos(np.pi * (2 * k - 1) * j / (2 * m))
    else:
        basis = coeff * np.cos(np.pi * (2 * k + 1) * j / (2 * m))
    return basis.astype(np.float32)


def num_frames(n_samples: int, frame_size: int, frame_step: int):
    """``1 + ceil((n - size)/step)`` (``AudioProcessing.py:216``)."""
    return 1 + -(-(n_samples - frame_size) // frame_step)


class Frontend:
    """Batched MFCC+Δ+ΔΔ extractor.

    Usage::

        fe = Frontend(cfg)
        feats, mask = fe.mfcc_batch(signals, n_samples)  # [B,T,D], [B,T]

    ``signals`` is zero-padded to a common length; ``n_samples`` carries
    true lengths.  Padded frames are masked out, and Δ edge replication
    respects each utterance's true frame count.
    """

    def __init__(self, cfg: FrontendConfig):
        self.cfg = cfg
        self.frame_size = cfg.frame_size
        self.frame_step = cfg.frame_step
        self._fbank = jnp.asarray(mel_filterbank_matrix(cfg))
        self._dct = jnp.asarray(dct_matrix(cfg))
        if not cfg.reference_quirks:
            n = np.arange(cfg.frame_size)
            w = (1 - cfg.hamming_alpha) - cfg.hamming_alpha * np.cos(
                2 * np.pi * n / (cfg.frame_size - 1)
            )
            self._window = jnp.asarray(w.astype(np.float32))
        else:
            self._window = None
        if cfg.matmul_dft:
            # DFT basis restricted to the first frame_size input rows
            # (the rFFT zero-pads frames to nfft).  cos and sin are
            # CONCATENATED into one [frame_size, 2K] operand so the
            # spectrum needs a single dot per batch instead of two
            # half-width ones (same FLOPs, one pass over the frames
            # operand).
            k = (
                np.arange(cfg.nfft)[:, None]
                * np.arange(cfg.nfft // 2 + 1)[None, :]
                * 2.0 * np.pi / cfg.nfft
            )[: cfg.frame_size]
            self._dft_cos = jnp.asarray(np.cos(k).astype(np.float32))
            self._dft_sin = jnp.asarray(np.sin(k).astype(np.float32))
            self._dft_cs = jnp.concatenate(
                [self._dft_cos, self._dft_sin], axis=1)
        self._mfcc_single = jax.jit(self._mfcc_impl)
        self._mfcc_batched = jax.jit(self.batch_impl)

    # ------------------------------------------------------------------
    def _frames(self, signal: jax.Array) -> jax.Array:
        """Frame blocking (``AudioProcessing.py:200-225``): 25 ms frames,
        50% hop, zero padding to a whole number of frames."""
        n = signal.shape[0]
        t = num_frames(n, self.frame_size, self.frame_step)
        pad = (t - 1) * self.frame_step + self.frame_size - n
        padded = jnp.pad(signal, (0, max(pad, 0)))
        idx = (
            jnp.arange(t)[:, None] * self.frame_step
            + jnp.arange(self.frame_size)[None, :]
        )
        return padded[idx]

    def _pre(self, signal: jax.Array, n_samples: jax.Array):
        """Pre-emphasis + true-frame-count bookkeeping.  Returns
        ``(pe_signal, t_true, mask)``."""
        cfg = self.cfg
        # Pre-emphasis (AudioProcessing.py:183-198): y_t = x_{t+1} - αx_t,
        # final element zero-filled.  Padded tail is zeros so the formula
        # stays exact for the valid region.
        pe = jnp.append(signal[1:] - cfg.pre_emphasis * signal[:-1], 0.0)
        # the reference zero-fills the *last true* sample
        # (AudioProcessing.py:196-197); with zero padding that position is
        # n_samples-1, not the end of the buffer
        pe = jnp.where(jnp.arange(pe.shape[0]) == n_samples - 1, 0.0, pe)
        t_pad = num_frames(signal.shape[0], self.frame_size, self.frame_step)
        # true frame count for this utterance
        t_true = 1 + jnp.ceil(
            (n_samples - self.frame_size) / self.frame_step
        ).astype(jnp.int32)
        t_true = jnp.clip(t_true, 1, t_pad)
        mask = jnp.arange(t_pad) < t_true
        return pe, t_true, mask

    def _core_xla(self, pe: jax.Array, t_true: jax.Array) -> jax.Array:
        """Framing → window → |DFT| → energy → mel → log → DCT → c0 on
        one pre-emphasized signal: ``[T_pad, dct_num]`` cepstra."""
        cfg = self.cfg
        frames = self._frames(pe)  # [T_pad, frame_size]
        t_pad = frames.shape[0]
        frame_idx = jnp.arange(t_pad)

        # Windowing
        if cfg.reference_quirks:
            # scalar per-frame window over the frame axis, length = true
            # frame count (AudioProcessing.py:242-245)
            w = (1 - cfg.hamming_alpha) - cfg.hamming_alpha * jnp.cos(
                2 * jnp.pi * frame_idx / jnp.maximum(t_true - 1, 1)
            )
            win = frames * w[:, None]
        else:
            win = frames * self._window[None, :]

        # |rFFT| (AudioProcessing.py:248-264); as one concatenated
        # [T, frame] @ [frame, 2K] DFT matmul when cfg.matmul_dft
        # (identical to ~1e-4 relative)
        if cfg.matmul_dft:
            # dot_precision: the DFT bins cancel, and the log amplifies
            # their relative error, so a reduced-precision pass moves
            # the log-cepstra visibly; 'highest' is f32-exact and the
            # default (FrontendConfig.dot_precision)
            prec = _PRECISION[cfg.dot_precision]
            k = self._dft_cos.shape[1]
            cs = jnp.dot(win, self._dft_cs,
                         preferred_element_type=jnp.float32,
                         precision=prec)
            re, im = cs[:, :k], cs[:, k:]
            spec = jnp.sqrt(re * re + im * im)  # [T, nfft//2+1]
        else:
            spec = jnp.abs(jnp.fft.rfft(win, n=cfg.nfft, axis=-1))

        # Optional spectral subtraction (Boll-style, flag-gated):
        # noise magnitude from the first vad_sample_size VALID frames
        # (the VAD's own noise window), over-subtract, floor — padding
        # frames are excluded from the estimate via the t_true mask
        if cfg.spectral_subtraction:
            n_noise = jnp.minimum(cfg.vad_sample_size, t_true)
            in_win = (frame_idx < n_noise)[:, None]
            noise = (jnp.sum(jnp.where(in_win, spec, 0.0), axis=0)
                     / jnp.maximum(n_noise, 1))
            spec = jnp.maximum(spec - cfg.ss_alpha * noise[None, :],
                               cfg.ss_floor * spec)

        # Frame energy (AudioProcessing.py:338: sum of magnitudes; textbook
        # mode uses power)
        if cfg.reference_quirks:
            energy = jnp.sum(spec, axis=-1)
        else:
            energy = jnp.sum(spec * spec, axis=-1)

        # Mel filterbank + log + DCT: two matmuls
        prec_small = _PRECISION[cfg.dot_precision] if cfg.matmul_dft \
            else jax.lax.Precision.HIGHEST
        fbank = jnp.dot(spec, self._fbank, preferred_element_type=jnp.float32,
                        precision=prec_small)
        log_fbank = jnp.log(jnp.maximum(fbank, _LOG_EPS))
        ceps = jnp.dot(log_fbank, self._dct, preferred_element_type=jnp.float32,
                       precision=prec_small)

        # c0 <- log frame energy (AudioProcessing.py:437-438)
        if cfg.energy_c0:
            ceps = ceps.at[:, 0].set(jnp.log(jnp.maximum(energy, _LOG_EPS)))

        # optional pitch column (capability beyond the reference: MFCC is
        # pitch-blind, Mandarin tones need F0)
        if cfg.pitch:
            ceps = jnp.concatenate(
                [ceps, self._pitch(frames)[:, None]], axis=-1)
        return ceps

    def _pitch(self, frames: jax.Array) -> jax.Array:
        """Per-frame F0 feature: autocorrelation peak in the
        [pitch_low_hz, pitch_high_hz] lag band, normalized by the
        zero-lag energy; voiced frames emit
        ``pitch_scale · log2(f0 / 125 Hz)``, unvoiced frames 0."""
        cfg = self.cfg
        fs = self.frame_size
        nfft_ac = 1
        while nfft_ac < 2 * fs:
            nfft_ac *= 2
        spec2 = jnp.abs(jnp.fft.rfft(frames, n=nfft_ac, axis=-1)) ** 2
        ac = jnp.fft.irfft(spec2, n=nfft_ac, axis=-1)[:, :fs]  # [T, fs]
        lag_min = max(2, int(cfg.sample_rate / cfg.pitch_high_hz))
        lag_max = min(fs - 1, int(cfg.sample_rate / cfg.pitch_low_hz))
        band = ac[:, lag_min: lag_max + 1]
        norm = jnp.maximum(ac[:, 0:1], _LOG_EPS)
        ratio = band / norm
        best = jnp.argmax(ratio, axis=-1)
        peak = jnp.take_along_axis(ratio, best[:, None], axis=-1)[:, 0]
        f0 = cfg.sample_rate / (best + lag_min).astype(jnp.float32)
        voiced = peak > cfg.pitch_voicing
        return jnp.where(
            voiced, cfg.pitch_scale * jnp.log2(f0 / 125.0), 0.0)

    def _post(self, ceps: jax.Array, t_true: jax.Array,
              mask: jax.Array) -> jax.Array:
        """CMVN → Δ/ΔΔ → padding mask on the ``[T_pad, dct_num]``
        cepstra (CMVN flag-gated, see :class:`FrontendConfig.cmvn`; the
        reference pipeline it extends is ``AudioProcessing.py:416-448``,
        which has no normalization stage)."""
        cfg = self.cfg
        if cfg.cmvn:
            # masked per-utterance statistics: padding must not leak
            # into the mean/variance (pad rows are rewritten by the
            # delta edge replication and the final mask anyway).  The
            # optional pitch column is excluded — its 0 encodes
            # "unvoiced", a sentinel a mean shift would destroy
            nc = cfg.dct_num
            valid = mask[:, None]
            denom = jnp.maximum(t_true, 1).astype(ceps.dtype)
            cep = ceps[:, :nc]
            mean = jnp.sum(jnp.where(valid, cep, 0.0), axis=0) / denom
            cep = cep - mean[None, :]
            if cfg.cmvn_var:
                var = jnp.sum(jnp.where(valid, cep * cep, 0.0),
                              axis=0) / denom
                cep = cep * jax.lax.rsqrt(var + 1e-8)[None, :]
            ceps = jnp.concatenate([cep, ceps[:, nc:]], axis=-1)
        feats = ceps
        if cfg.delta_1:
            d1 = self._delta(ceps, t_true)
            feats = jnp.concatenate([feats, d1], axis=-1)
            if cfg.delta_2:
                d2 = self._delta(d1, t_true)
                feats = jnp.concatenate([feats, d2], axis=-1)
        return jnp.where(mask[:, None], feats, 0.0)

    def _mfcc_impl(self, signal: jax.Array, n_samples: jax.Array):
        """Full pipeline on one (padded) signal.  Returns (feats, mask)."""
        pe, t_true, mask = self._pre(signal, n_samples)
        ceps = self._core_xla(pe, t_true)
        return self._post(ceps, t_true, mask), mask

    # ------------------------------------------------------------------
    def batch_impl(self, signals, n_samples):
        """Traceable batched pipeline (embed inside an outer jit).
        Returns ``([B, T, D] feats, [B, T] mask)``.

        The frontend is plain XLA: one [B*T, frame] @ [frame, 2K] DFT
        matmul plus elementwise fusion (an earlier fused Pallas kernel
        lost to it on the previous accelerator and was removed; not yet
        measured on the H100).
        """
        signals = jnp.asarray(signals, dtype=jnp.float32)
        n_samples = jnp.asarray(n_samples)
        return jax.vmap(self._mfcc_impl)(signals, n_samples)

    def _delta(self, feat: jax.Array, t_true: jax.Array) -> jax.Array:
        """±n-frame regression deltas with edge replication
        (``AudioProcessing.py:400-414``), clamped to the true frame count
        so padding never leaks into the regression."""
        # One banded [T_pad, T_pad] matmul: delta = W @ f, where W carries
        # the ±n regression weights with edge replication folded into the
        # first/last rows.  The dynamic clip at t_true-1 is realized by
        # first replicating the last *true* row into the padding, after
        # which the static end-of-buffer edge rows are already correct.
        # (Chosen over a [T, 2n+1, D] gather and over shifted adds for
        # the previous accelerator; not yet measured on the H100.)
        last = jnp.take(feat, t_true - 1, axis=0)
        valid = jnp.arange(feat.shape[0])[:, None] < t_true
        f = jnp.where(valid, feat, last[None, :])
        # HIGHEST: at default precision the GPU runs this in TF32, which
        # moved the MFCC+Δ+ΔΔ features by 2.1e-3 against the 3e-4 bar
        # (chip_smoke.py on an H100)
        return jnp.dot(jnp.asarray(self._delta_w(feat.shape[0])), f,
                       preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)

    @functools.lru_cache(maxsize=8)
    def _delta_w(self, t_pad: int) -> np.ndarray:
        """Banded delta-regression matrix ``W[t, u] = k/denom`` for
        ``u = clip(t+k, 0, t_pad-1)``, k in [-n, n]."""
        n = self.cfg.delta_n
        denom = 2 * sum(i * i for i in range(1, n + 1))
        w = np.zeros((t_pad, t_pad), np.float32)
        rows = np.arange(t_pad)
        for k in range(-n, n + 1):
            np.add.at(w, (rows, np.clip(rows + k, 0, t_pad - 1)), k / denom)
        return w

    # ------------------------------------------------------------------
    def mfcc(self, signal, n_samples=None):
        """Single-utterance features: ``[T, D]`` plus frame mask ``[T]``."""
        signal = jnp.asarray(signal, dtype=jnp.float32)
        if n_samples is None:
            n_samples = signal.shape[0]
        return self._mfcc_single(signal, jnp.asarray(n_samples))

    def mfcc_batch(self, signals, n_samples):
        """Batch of padded utterances: ``[B, T, D]`` features + ``[B, T]``
        frame mask (replaces the per-utterance ``__load_audio`` loop,
        ``AcousticModel.py:463-477``)."""
        signals = jnp.asarray(signals, dtype=jnp.float32)
        return self._mfcc_batched(signals, jnp.asarray(n_samples))
