"""Run a plucked-string DI riff through the NeuralAmp TCN, block by
block, and prove the stream equals one-shot offline inference.

This is the user-facing shape of the NeuralAmp extension benchmark
(docs/BENCHMARKS.md "NeuralAmp"): a Karplus-Strong guitar line is
streamed through the dilated-TCN amp model one 512-sample block at a
time -- exactly the per-block step the benchmark times -- with the
per-layer receptive-field tails carried across blocks
(ops/neuralamp.py tcn_block). At the end, the streamed output is
checked against running the ENTIRE take through the same network as
one giant block from zero state: block-streaming with carried context
must reproduce offline inference to float32 rounding, which is the
property that makes the benchmark's ms/block a real amp plugin's
latency.

The network weights are the benchmark's seeded random initialization,
so the "amp" is an arbitrary (but fixed) nonlinear residual stack --
the tanh layers add drive-like waveshaping; the point is the engine,
not a trained tone.

Run:  python examples/ampsim.py [--seconds 4] [--layers 8]
                                [--out riff_amp.wav]
"""

from __future__ import annotations

import argparse
import os
import sys
import wave

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from examples.streaming_synth import BLOCK, FS

# noqa: E402 imports below need the repo root on sys.path first.


def pluck(n: int, f0: float, fs: int = FS, seed: int = 42) -> np.ndarray:
    """Karplus-Strong pluck: noise burst in a lowpass-damped delay
    line (the classic plucked-string physical model)."""
    period = max(2, int(round(fs / f0)))
    rng = np.random.default_rng(seed)
    buf = rng.uniform(-1.0, 1.0, period)
    out = np.empty(n)
    idx = 0
    for i in range(n):
        cur = buf[idx]
        nxt = buf[(idx + 1) % period]
        out[i] = cur
        buf[idx] = 0.996 * 0.5 * (cur + nxt)
        idx = (idx + 1) % period
    return out


def render_riff(seconds: float) -> np.ndarray:
    """A four-note DI line (A2 D3 E3 A3), one pluck per half second."""
    n = max(BLOCK, int(seconds * FS))
    riff = np.zeros(n)
    notes = [110.0, 146.83, 164.81, 220.0]
    step = FS // 2
    for k, f0 in enumerate(notes):
        start = k * step
        if start >= n:
            break
        riff[start:] += pluck(n - start, f0, seed=42 + k)
    peak = float(np.abs(riff).max()) or 1.0
    return (0.7 * riff / peak).astype(np.float32)


def stream_amp(dry: np.ndarray, params, layers: int) -> np.ndarray:
    """Stream dry (1-D) through the TCN block by block, carrying the
    receptive-field tails -- the benchmark's exact step."""
    import jax
    import jax.numpy as jnp

    from gpuaudiobench_jax.ops import neuralamp as na

    channels = params["w_in"].shape[0]
    cp = na.cast_params(params, "f32")
    n_blocks = len(dry) // BLOCK
    blocks = jnp.asarray(dry[: n_blocks * BLOCK].reshape(n_blocks, 1, BLOCK))
    tails0 = tuple(
        jnp.asarray(t) for t in na.init_tails(1, channels, layers))

    def body(tails, x):
        y, tails2 = na.tcn_block(x, tails, cp, layers=layers, dtype="f32")
        return tails2, y

    _, wet = jax.jit(lambda c, xs: jax.lax.scan(body, c, xs))(tails0, blocks)
    return np.asarray(wet).ravel()


def offline_amp(dry: np.ndarray, params, layers: int) -> np.ndarray:
    """The same network applied to the whole take as ONE block from
    zero state (offline inference, no streaming)."""
    import jax.numpy as jnp

    from gpuaudiobench_jax.ops import neuralamp as na

    channels = params["w_in"].shape[0]
    cp = na.cast_params(params, "f32")
    x = jnp.asarray(dry[None, :])
    tails = tuple(jnp.asarray(t) for t in na.init_tails(1, channels, layers))
    y, _ = na.tcn_block(x, tails, cp, layers=layers, dtype="f32")
    return np.asarray(y).ravel()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--channels", type=int, default=16)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", default="riff_amp.wav")
    args = ap.parse_args(argv)

    from gpuaudiobench_jax.ops import neuralamp as na

    dry = render_riff(args.seconds)
    params = na.init_params(args.seed, args.channels, args.layers)
    wet = stream_amp(dry, params, args.layers)
    n = len(wet)

    offline = offline_amp(dry[:n], params, args.layers)
    err = float(np.abs(wet - offline).max())
    peak = float(np.abs(offline).max()) or 1.0
    stream_ok = err <= 1e-4 * peak

    scale = float(np.abs(wet).max()) or 1.0
    pcm = (np.clip(wet / scale, -1, 1) * 32767.0).astype("<i2")
    with wave.open(args.out, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(FS)
        w.writeframes(pcm.tobytes())

    rf = na.receptive_field(args.layers)
    print(f"wrote {args.out}: {n / FS:.2f} s through a depth-"
          f"{args.layers} TCN ({args.channels} ch, receptive field "
          f"{rf} samples = {1000.0 * rf / FS:.1f} ms)")
    print(f"streamed inference matches offline: {stream_ok} "
          f"(max err {err:.2e} vs peak {peak:.3f})")
    return 0 if stream_ok else 1


if __name__ == "__main__":
    sys.exit(main())
