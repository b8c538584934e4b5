"""Mix a multi-track bell chord through the full DAWSessionMix graph,
block-streamed, and prove the stream equals the offline render.

This is the user-facing shape of the DAWSessionMix extension benchmark
(docs/BENCHMARKS.md "DAWSessionMix"): every 512-sample block runs the
whole session as ONE jitted program -- per-track biquad EQ cascades,
post-fader sends summed into a stereo partitioned-convolution reverb
bus, constant-power pan mixdown -- with all state (EQ z's, previous
bus block, the reverb's frequency-domain delay line) carried across
blocks. Unlike the benchmark (which repeats one block to keep its
golden closed-form), this streams REAL varying program material: a
chord of decaying bell notes, one note per track.

At the end the streamed stereo mix is checked against an offline
render of the identical console: float32 sample-loop EQ over the whole
take (models/iir.py iir_reference, the op-order-exact recurrence), one
float64 FFT convolution of the whole bus signal, the same pan/wet
algebra. Block-by-block engine and one-shot render must agree to
float32 rounding (peak-relative) -- the property that makes the
benchmark's per-block latency a real session's latency.

Run:  python examples/session.py [--seconds 3] [--tracks 6]
                                 [--rt60 1.0] [--eq-stages 4]
                                 [--out chord_mix.wav]
"""

from __future__ import annotations

import argparse
import os
import sys
import wave

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from examples.streaming_synth import BLOCK, FS, bell_modes, make_stream

# noqa: E402 imports below need the repo root on sys.path first.


def render_tracks(seconds: float, n_tracks: int, modes: int,
                  f0: float) -> np.ndarray:
    """(T, N) dry take: one bell note per track, a stacked-fourths
    chord (f0 * 4/3 per step) so the tracks are genuinely distinct."""
    n_blocks = max(1, int(seconds * FS / BLOCK))
    takes = []
    for t in range(n_tracks):
        run_blocks, carry = make_stream(*bell_modes(
            modes, f0 * (4.0 / 3.0) ** t, seed=7 + t))
        _, blocks = run_blocks(carry, n_blocks)
        takes.append(np.asarray(blocks).ravel().astype(np.float32))
    return np.stack(takes)


def stream_session(tracks: np.ndarray, stage_coeffs, send, pan2,
                   ir: np.ndarray) -> np.ndarray:
    """(2, N) streamed mix: scan the benchmark's exact per-block core
    over the take's blocks, state carried."""
    import jax
    import jax.numpy as jnp

    from gpuaudiobench_jax.models.session import make_session_core
    from gpuaudiobench_jax.ops.partconv import num_partitions

    t, n = tracks.shape
    n_blocks = n // BLOCK
    p = num_partitions(ir.shape[1], BLOCK)
    xs = jnp.asarray(
        tracks[:, : n_blocks * BLOCK].reshape(t, n_blocks, BLOCK)
    ).transpose(1, 0, 2)  # (blocks, T, B)

    from gpuaudiobench_jax.ops.partconv import partition_spectra

    h_re, h_im = partition_spectra(jnp.asarray(ir), BLOCK)
    core = make_session_core()
    coeffs = jnp.asarray(np.array(stage_coeffs, np.float32))
    send_d, pan2_d = jnp.asarray(send), jnp.asarray(pan2)

    def body(carry, x):
        eq, prev, fre, fim = carry
        mix, eq2, xbus, fre2, fim2 = core(
            x, coeffs, eq, send_d, pan2_d, prev, fre, fim, h_re, h_im)
        return (eq2, xbus, fre2, fim2), mix

    carry0 = (
        jnp.zeros((len(stage_coeffs), t, 2), jnp.float32),
        jnp.zeros((2, BLOCK), jnp.float32),
        jnp.zeros((2, p, BLOCK + 1), jnp.float32),
        jnp.zeros((2, p, BLOCK + 1), jnp.float32),
    )
    _, mixes = jax.jit(lambda c, x: jax.lax.scan(body, c, x))(carry0, xs)
    return np.asarray(mixes).transpose(1, 0, 2).reshape(2, -1)


def offline_session(tracks: np.ndarray, stage_coeffs, send, pan2,
                    ir: np.ndarray, wet: float) -> np.ndarray:
    """(2, N) one-shot render of the identical console: f32 sample-loop
    EQ, one f64 FFT convolution of the whole bus, same mix algebra."""
    from gpuaudiobench_jax.models.iir import iir_reference

    t, n = tracks.shape
    y = tracks
    state = [np.zeros((t, 2), np.float32) for _ in stage_coeffs]
    for s, c in enumerate(stage_coeffs):
        y, state[s] = iir_reference(y, c, state[s])
    bus = send.astype(np.float64) @ y.astype(np.float64)  # (N,)
    nfft = n + ir.shape[1]
    rev = np.fft.irfft(
        np.fft.rfft(bus, nfft)[None]
        * np.fft.rfft(ir.astype(np.float64), nfft, axis=1),
        nfft, axis=1)[:, :n]
    dry = pan2.astype(np.float64) @ y.astype(np.float64)
    return (dry + wet * rev).astype(np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--tracks", type=int, default=6)
    ap.add_argument("--modes", type=int, default=1024)
    ap.add_argument("--f0", type=float, default=165.0)
    ap.add_argument("--rt60", type=float, default=1.0,
                    help="reverb time (s); IR length = rt60 * 48000")
    ap.add_argument("--eq-stages", type=int, default=4)
    ap.add_argument("--out", default="chord_mix.wav")
    args = ap.parse_args(argv)

    from gpuaudiobench_jax.models.session import (
        WET_GAIN,
        session_mix_params,
    )
    from gpuaudiobench_jax.utils.data import (
        biquad_lowpass_coefficients,
        reverb_impulse_responses,
    )

    tracks = render_tracks(args.seconds, args.tracks, args.modes, args.f0)
    n = (tracks.shape[1] // BLOCK) * BLOCK
    tracks = tracks[:, :n]
    stage_coeffs = [biquad_lowpass_coefficients(0.25 - 0.0125 * k)
                    for k in range(args.eq_stages)]
    send, pan2 = session_mix_params(args.tracks, seed=42)
    ir = reverb_impulse_responses(2, max(BLOCK, int(args.rt60 * FS)))

    mix = stream_session(tracks, stage_coeffs, send, pan2, ir)
    ref = offline_session(tracks, stage_coeffs, send, pan2, ir, WET_GAIN)

    peak = float(np.abs(ref).max())
    err = float(np.abs(mix - ref).max())
    stream_ok = err <= 1e-4 * max(peak, 1e-12)

    scale = max(1e-9, float(np.abs(mix).max())) / 0.9
    pcm = (np.clip(mix / scale, -1, 1) * 32767.0).astype("<i2")
    with wave.open(args.out, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(FS)
        w.writeframes(pcm.T.reshape(-1).tobytes())  # interleave L/R

    print(f"wrote {args.out}: {n / FS:.2f} s stereo, {args.tracks} strips "
          f"x {args.eq_stages}-stage EQ, rt60 {args.rt60:.2f} s "
          f"({ir.shape[1]} taps = {-(-ir.shape[1] // BLOCK)} partitions)")
    print(f"streamed session matches offline: {stream_ok} "
          f"(max err {err:.2e} vs peak {peak:.3f})")
    return 0 if stream_ok else 1


if __name__ == "__main__":
    sys.exit(main())
