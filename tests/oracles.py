"""NumPy oracles reimplementing the reference's documented semantics.

These are *independent reimplementations* of the algorithms in
``/root/reference`` (cited per function), written from the behavioral
analysis in SURVEY.md, used as golden references for the device kernels.
They intentionally reproduce the reference's numeric quirks.
"""

from __future__ import annotations

import math

import numpy as np


# ----------------------------------------------------------------------
# MFCC pipeline oracle (StatisticalModel/AudioProcessing.py:183-448)
# ----------------------------------------------------------------------

def pre_emphasis(signal, alpha=0.98):
    """AudioProcessing.py:183-198."""
    y = signal[1:] - alpha * signal[:-1]
    return np.append(y, 0.0)


def frame_blocking(signal, framerate, sampletime=0.025, overlap=0.5):
    """AudioProcessing.py:200-225."""
    samplenum = len(signal)
    framesize = int(framerate * sampletime)
    step = int(framesize * overlap)
    framenum = 1 + math.ceil((samplenum - framesize) / step)
    padnum = (framenum - 1) * step + framesize
    padsignal = np.concatenate((signal, np.zeros(int(padnum - samplenum))))
    indices = (
        np.tile(np.arange(0, framesize), (framenum, 1))
        + np.tile(np.arange(0, framenum * step, step), (framesize, 1)).T
    )
    return padsignal[indices.astype(np.int32)]


def hamming_window_quirk(frames, alpha=0.46):
    """AudioProcessing.py:227-246 — the window runs over the *frame index*."""
    frames = frames.astype(np.float64).copy()
    length = len(frames)
    for i in range(length):
        frames[i] *= (1 - alpha) - alpha * math.cos(2 * math.pi * i / (length - 1))
    return frames


def fft_mag(frames, nfft=512):
    """AudioProcessing.py:248-264."""
    return np.absolute(np.fft.rfft(frames, nfft))


def mel_filter_bank_quirk(spec, samplerate, nfft=512, low_hz=0.0, high_hz=None,
                          filterbanks=26):
    """AudioProcessing.py:278-344 (ascending-sawtooth falling edge)."""
    high_hz = high_hz or samplerate / 2
    mel_min = 2595 * math.log(1 + low_hz / 700, math.e)
    mel_max = 2595 * math.log(1 + high_hz / 700, math.e)
    mel = np.linspace(mel_min, mel_max, filterbanks + 2)
    hz = 700 * (np.exp(mel / 2595) - 1)
    energy = np.sum(spec, 1)
    bins = np.floor((nfft + 1) / samplerate * hz)
    response = np.zeros((filterbanks, nfft // 2 + 1))
    for i in range(filterbanks):
        for j in range(int(bins[i]), int(bins[i + 1])):
            response[i][j] = (j - int(bins[i])) / (bins[i + 1] - bins[i])
        for j in range(int(bins[i + 1]), int(bins[i + 2])):
            response[i][j] = (j - int(bins[i + 1])) / (bins[i + 2] - bins[i + 1])
    return np.dot(spec, response.T), energy


def dct_quirk(s, rank=13):
    """AudioProcessing.py:346-370 — (2k-1) index, coefficient 2/sqrt(M).

    (vectorized form of the reference's triple loop; identical numerics
    modulo float association order)"""
    log_energy = np.log(s)
    m = s.shape[1]
    coeff = 2 / m ** 0.5
    k = np.arange(m)[:, None]
    j = np.arange(rank)[None, :]
    basis = coeff * np.cos(np.pi * (2 * k - 1) * j / (2 * m))
    return log_energy @ basis


def cal_delta(feat, n=2):
    """AudioProcessing.py:400-414."""
    framenum = len(feat)
    denominator = 2 * sum(i ** 2 for i in range(1, n + 1))
    delta_feat = np.empty_like(feat)
    padded = np.pad(feat, ((n, n), (0, 0)), mode="edge")
    for t in range(framenum):
        delta_feat[t] = (
            np.dot(np.arange(-n, n + 1), padded[t: t + 2 * n + 1]) / denominator
        )
    return delta_feat


def mfcc_quirk(signal, rate=16000, nfft=512, dct_num=13, d1=True, d2=True,
               log_eps=0.0):
    """Full reference pipeline (AudioProcessing.py:416-448), quirks mode.

    ``log_eps`` floors the filterbank output before the log (the device
    pipeline floors at 1e-10 to avoid -inf; pass the same value when
    comparing)."""
    pe = pre_emphasis(signal)
    fb = frame_blocking(pe, rate)
    win = hamming_window_quirk(fb)
    spec = fft_mag(win, nfft)
    fbank, energy = mel_filter_bank_quirk(spec, rate, nfft=nfft)
    if log_eps:
        fbank = np.maximum(fbank, log_eps)
        energy = np.maximum(energy, log_eps)
    coeffs = dct_quirk(fbank, rank=dct_num)
    coeffs[:, 0] = np.log(energy)
    feats = coeffs
    if d1:
        delta = cal_delta(coeffs)
        feats = np.concatenate((feats, delta), 1)
        if d2:
            feats = np.concatenate((feats, cal_delta(delta)), 1)
    return feats


# ----------------------------------------------------------------------
# VAD oracle (StatisticalModel/AudioProcessing.py:450-543)
# ----------------------------------------------------------------------

def vad_keep_mask(mfcc, simple_size=16, alpha=0.5, beta=0.93):
    """Returns the boolean keep-mask the reference's VAD implies
    (``detect`` keeps frames with smoothed distance > threshold)."""
    simple = mfcc[:simple_size]
    noise = simple.sum(axis=0) / simple_size
    for i in range(simple_size):
        noise = alpha * noise + (1 - alpha) * mfcc[i]
    dist = np.array([np.sqrt(np.dot(noise - f, noise - f)) for f in mfcc])

    smoothed = dist.copy()
    h = int(beta * (2 * simple_size + 1))
    for i in range(simple_size, len(mfcc) - simple_size):
        w = np.sort(dist[i - simple_size: i + simple_size].copy())
        smoothed[i] = (1 - beta) * w[h] + beta * w[h + 1]

    d_mid = smoothed[simple_size // 2]
    thresh = d_mid * (smoothed.max() - smoothed.min()) / smoothed.max()
    return smoothed - thresh > 0.0


# ----------------------------------------------------------------------
# HMM oracles (StatisticalModel/LHMM.py:335-366, 546-609)
# ----------------------------------------------------------------------

def np_logsumexp(v, axis=None):
    v = np.asarray(v, dtype=np.float64)
    m = np.max(v, axis=axis, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    out = np.squeeze(m, axis=axis) if axis is not None else m.squeeze()
    with np.errstate(divide="ignore"):
        return out + np.log(np.sum(np.exp(v - m), axis=axis))


def forward_oracle(log_transmat, log_pi, log_b):
    """LHMM.__forward_algorithm (LHMM.py:335-351).

    :param log_b: [N, T] observation log-probs; returns log-alpha [N, T].
    """
    n, t = log_b.shape
    alpha = np.zeros((n, t))
    alpha[:, 0] = log_pi + log_b[:, 0]
    for i in range(1, t):
        for j in range(n):
            alpha[j, i] = np_logsumexp(alpha[:, i - 1] + log_transmat[:, j])
        alpha[:, i] += log_b[:, i]
    return alpha


def backward_oracle(log_transmat, log_b):
    """LHMM.__backward_algorithm (LHMM.py:353-366): beta[:, T-1] = 0."""
    n, t = log_b.shape
    beta = np.zeros((n, t))
    for i in range(t - 2, -1, -1):
        for j in range(n):
            beta[j, i] = np_logsumexp(
                log_transmat[j, :] + log_b[:, i + 1] + beta[:, i + 1]
            )
    return beta


def viterbi_oracle(transmat, prob, pi, end_state_back=False):
    """LHMM.viterbi (LHMM.py:546-609).

    :param prob: [N, T] log observation matrix; transmat/pi linear.
    :returns: (best final score ``point``, state index path [T])
    """
    s_len, t = prob.shape
    mark_state = np.zeros((t,), dtype=np.int64)
    before_state = [[0 for _ in range(t)] for _ in range(s_len)]
    with np.errstate(divide="ignore"):
        p_list = np.log(pi) + prob[:, 0]
        max_index = 0
        for i in range(1, t):
            p_ = np.zeros_like(p_list)
            for j in range(s_len):
                tmp = p_list + np.log(transmat[:, j])
                max_p = tmp.max()
                p_[j] = max_p
                max_index = np.where(tmp == max_p)[0][0]
                before_state[j][i] = max_index
            p_list = p_ + prob[:, i]

    if end_state_back:
        end_index = len(p_list) - 4 + np.where(p_list[-4:] == p_list[-4:].max())[0][0]
        point = p_list[end_index]
        # NB the reference then backtracks from `max_index` (the loop
        # leftover), a latent bug; our oracle backtracks from end_index.
        back_from = end_index
    else:
        back_from = np.where(p_list == p_list.max())[0][0]
        point = p_list[back_from]

    before_index = back_from
    for i in range(t - 1, -1, -1):
        mark_state[i] = before_index
        before_index = before_state[before_index][i]
    return point, mark_state


# ----------------------------------------------------------------------
# Embedded sentence-HMM oracle (AcousticModel/AcousticModel.py:957-1014)
# ----------------------------------------------------------------------

def embedded_oracle(unit_transmats, unit_scores, state_num):
    """Dense sentence HMM the reference way.

    :param unit_transmats: list of [N, N] linear transmats, one per label unit
    :param unit_scores: list of [emit, T] GMM log-score rows per label unit
    :returns: (complex_transmat [Ns, Ns] linear, complex_prob [Ns, T] log,
               complex_pi [Ns] linear)
    """
    L = len(unit_transmats)
    emit = state_num - 2
    state_size = emit * L + 2
    t = unit_scores[0].shape[1]

    # transmat (AcousticModel.py:978-988)
    A = np.zeros((state_size, state_size))
    A[: state_num - 1, : state_num] = unit_transmats[0][:-1]
    for i in range(L):
        a = i * emit + 1
        b = (i + 1) * emit + 1
        A[a:b, a - 1: a - 1 + state_num] = unit_transmats[i][1:-1]

    # prob (AcousticModel.py:990-1001): entry row = log(1) = 0,
    # exit row = log(0) = -inf (VirtualState semantics)
    rows = [np.zeros((1, t))]
    for i in range(L):
        rows.append(unit_scores[i])
    rows.append(np.full((1, t), -np.inf))
    prob = np.concatenate(rows, axis=0)

    pi = np.ones((state_size,)) / state_size
    return A, prob, pi
