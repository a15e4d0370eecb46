"""Stereo CD audio synthesised from a seed.

Music-like content, not a test tone, so that bits per sample and the
entropy coder's work are those of music: sections of 3-12 s, each with a
voice of several partials whose pitch drifts (vibrato and a slow glide),
noise shaped to a band with a spectral tilt, percussive bursts, and its
own level; a few sections are quiet or digitally silent. The two channels
pan the partials apart and share part of the noise. Every random choice
comes from `numpy.random.default_rng` seeded with (seed, stream, index),
so one seed gives the same samples on every machine.
"""

from __future__ import annotations

import numpy as np

RATE = 44100


def rng_for(seed: int, stream: int, index: int = 0) -> np.random.Generator:
    """The generator for one purpose (`stream`) and item of a run's seed;
    any whole number is a seed."""
    return np.random.default_rng(
        np.random.SeedSequence([abs(int(seed)), int(seed < 0), stream, index]))


def _shaped_noise(rng, n: int, rate: int) -> np.ndarray:
    """(n, 2) noise in a random band with a random tilt; the channels
    share a random part of it."""
    lo = rng.uniform(40.0, 800.0)
    hi = rng.uniform(3000.0, 18000.0)
    tilt = rng.uniform(0.3, 1.4)            # amplitude ~ f^-tilt/2
    size = 1 << max(int(n - 1).bit_length(), 4)   # a fast FFT length
    freqs = np.fft.rfftfreq(size, 1.0 / rate)
    shape = np.where((freqs >= lo) & (freqs <= hi),
                     (np.maximum(freqs, lo) / lo) ** (-tilt / 2), 0.0)
    shape /= np.sqrt(np.mean(shape ** 2)) + 1e-12
    common, left, right = np.fft.irfft(
        np.fft.rfft(rng.standard_normal((3, size))) * shape, size)[:, :n]
    share = rng.uniform(0.3, 0.9)
    a, b = np.sqrt(share), np.sqrt(1 - share)
    return np.stack([a * common + b * left, a * common + b * right], 1)


def _voice(rng, n: int, rate: int) -> np.ndarray:
    """(n, 2) partials of a drifting pitch, panned apart, unit peak-ish."""
    f0 = np.exp(rng.uniform(np.log(55.0), np.log(700.0)))
    t = np.arange(n) / rate
    glide = np.exp(rng.uniform(-0.25, 0.25) * t / max(t[-1], 1e-9))
    vib = 1.0 + rng.uniform(0.001, 0.006) * np.sin(
        2 * np.pi * rng.uniform(4.0, 6.5) * t + rng.uniform(0, 2 * np.pi))
    phase = 2 * np.pi * np.cumsum(f0 * glide * vib) / rate
    k_max = int(rng.integers(5, 11))
    roll = rng.uniform(0.7, 1.6)
    out = np.zeros((n, 2))
    # sin(k x) by the recurrence 2 cos(x) sin((k-1) x) - sin((k-2) x)
    two_cos = 2.0 * np.cos(phase)
    prev, cur = np.zeros(n), np.sin(phase)
    for k in range(1, k_max + 1):
        if f0 * k * 1.3 > rate / 2:
            break
        amp = k ** -roll * rng.uniform(0.5, 1.0)
        pan = rng.uniform(0.15, 0.85)
        out[:, 0] += cur * (amp * np.sqrt(1 - pan))
        out[:, 1] += cur * (amp * np.sqrt(pan))
        prev, cur = cur, two_cos * cur - prev
    # a note envelope: attacks and decays every 0.2-1.2 s
    env = np.ones(n)
    pos = 0
    while pos < n:
        dur = int(rng.uniform(0.2, 1.2) * rate)
        seg = np.arange(min(dur, n - pos)) / rate
        env[pos:pos + dur] = (1 - np.exp(-seg / 0.01)) * np.exp(
            -seg / rng.uniform(0.3, 2.0)) * 0.7 + 0.3
        pos += dur
    return out * env[:, None]


def _bursts(rng, n: int, rate: int) -> np.ndarray:
    """(n, 2) percussive noise bursts, about two a second."""
    out = np.zeros((n, 2))
    count = rng.poisson(2.0 * n / rate)
    for start in rng.integers(0, max(n, 1), size=count):
        length = min(int(rng.uniform(0.03, 0.25) * rate), n - start)
        decay = np.exp(-np.arange(length) / (length / 5.0 + 1))
        out[start:start + length] += (rng.standard_normal((length, 2))
                                      * decay[:, None] * rng.uniform(0.2, 1.0))
    return out


def track(seed: int, index: int, n_frames: int, stream: int = 0,
          rate: int = RATE) -> np.ndarray:
    """One track: (n_frames, 2) int16 stereo PCM."""
    rng = rng_for(seed, stream, index)
    pcm = np.zeros((n_frames, 2), np.int16)
    pos = 0
    while pos < n_frames:
        n = min(int(rng.uniform(3.0, 12.0) * rate), n_frames - pos)
        kind = rng.uniform()
        if kind < 0.04:
            pos += n                          # digital silence
            continue
        mix = (_voice(rng, n, rate) * rng.uniform(0.5, 1.0)
               + _shaped_noise(rng, n, rate) * rng.uniform(0.03, 0.25)
               + _bursts(rng, n, rate) * rng.uniform(0.0, 0.6))
        peak = np.max(np.abs(mix)) + 1e-12
        level_db = rng.uniform(-18.0, -1.0) if kind >= 0.12 \
            else rng.uniform(-60.0, -40.0)    # a quiet passage
        gain = 32767.0 * 10 ** (level_db / 20) / peak
        fade = min(n, int(0.02 * rate))
        ramp = np.ones(n)
        ramp[:fade] = np.linspace(0.0, 1.0, fade, endpoint=False)
        ramp[n - fade:] = np.minimum(ramp[n - fade:],
                                     np.linspace(1.0, 0.0, fade))
        seg = np.rint(mix * (gain * ramp)[:, None] + rng.uniform(
            -0.5, 0.5, (n, 2)))
        pcm[pos:pos + n] = np.clip(seg, -32768, 32767).astype(np.int16)
        pos += n
    return pcm
