"""Run the struck bell through a convolution reverb, block-streamed
through the PartConv engine, and prove the stream equals the offline
convolution.

This is the user-facing shape of the PartConv extension benchmark
(docs/BENCHMARKS.md "PartConv"): a long decaying-noise room IR is
split into bufferSize partitions and streamed through the
frequency-domain delay line one 512-sample block at a time -- exactly
the per-block step the benchmark times, in any of the three FDL forms
(--form ring | shift | nupols; nupols is the two-level Gardner
long-IR scheme). At the end, the streamed wet signal is checked
against a single offline float64 FFT convolution of the whole dry
take: the block-by-block engine and the one-shot convolution must
agree to float32 rounding (peak-relative), which is the property that
makes the benchmark's latency a real reverb's latency.

Run:  python examples/reverb.py [--seconds 3] [--rt60 1.2]
                                [--form nupols] [--out bell_hall.wav]
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


def render_dry(seconds: float, modes: int, f0: float) -> np.ndarray:
    run_blocks, carry = make_stream(*bell_modes(modes, f0))
    n_blocks = max(1, int(seconds * FS / BLOCK))
    _, blocks = run_blocks(carry, n_blocks)
    return np.asarray(blocks).ravel().astype(np.float32)


def stream_reverb(dry: np.ndarray, ir: np.ndarray,
                  form: str = "ring", tail_chunk: int = 8) -> np.ndarray:
    """Stream dry (1-D) through the partitioned FDL, block by block,
    the benchmark's exact step — any of the three forms."""
    import jax
    import jax.numpy as jnp

    from gpuaudiobench_jax.ops.partconv import (
        make_partconv_block_nupols,
        num_partitions,
        nupols_init_state,
        nupols_spectra,
        nupols_tail_partitions,
        partconv_block,
        partconv_block_ring,
        partition_spectra,
        ring_aligned_spectra,
    )

    n_blocks = len(dry) // BLOCK
    p = num_partitions(ir.shape[1], BLOCK)
    blocks = jnp.asarray(dry[: n_blocks * BLOCK].reshape(n_blocks, 1, BLOCK))

    if form == "nupols":
        m = nupols_tail_partitions(ir.shape[1], BLOCK, tail_chunk)
        if m == 0:
            raise SystemExit("--form nupols needs irLength > "
                             f"{tail_chunk * BLOCK} taps (the K-block "
                             "head); use --rt60 >= "
                             f"{tail_chunk * BLOCK / FS + 0.1:.2f}")
        (hh_re, hh_im), (ht_re, ht_im) = nupols_spectra(
            jnp.asarray(ir), BLOCK, tail_chunk)
        nblock = make_partconv_block_nupols(BLOCK, tail_chunk, m)

        def body(carry, x):
            y, carry2 = nblock(x, carry, hh_re, hh_im, ht_re, ht_im)
            return carry2, y

        carry0 = tuple(jnp.asarray(a)
                       for a in nupols_init_state(1, BLOCK, tail_chunk, m))
    elif form == "ring":
        h_re, h_im = ring_aligned_spectra(
            *partition_spectra(jnp.asarray(ir), BLOCK))

        def body(carry, x):
            prev, head, fre, fim = carry
            y, head2, fre2, fim2 = partconv_block_ring(
                x, prev, head, fre, fim, h_re, h_im)
            return (x, head2, fre2, fim2), y

        carry0 = (
            jnp.zeros((1, BLOCK), jnp.float32),
            jnp.int32(p - 1),
            jnp.zeros((1, p, BLOCK + 1), jnp.float32),
            jnp.zeros((1, p, BLOCK + 1), jnp.float32),
        )
    else:  # shift
        h_re, h_im = partition_spectra(jnp.asarray(ir), BLOCK)

        def body(carry, x):
            prev, fre, fim = carry
            y, fre2, fim2 = partconv_block(x, prev, fre, fim, h_re, h_im)
            return (x, fre2, fim2), y

        carry0 = (
            jnp.zeros((1, BLOCK), jnp.float32),
            jnp.zeros((1, p, BLOCK + 1), jnp.float32),
            jnp.zeros((1, p, BLOCK + 1), jnp.float32),
        )

    _, wet = jax.jit(lambda c, xs: jax.lax.scan(body, c, xs))(carry0, blocks)
    return np.asarray(wet).ravel()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--rt60", type=float, default=1.2,
                    help="reverb time (s); IR length = rt60 * 48000")
    ap.add_argument("--modes", type=int, default=2048)
    ap.add_argument("--f0", type=float, default=220.0)
    ap.add_argument("--mix", type=float, default=0.35,
                    help="wet/dry mix (0 = dry, 1 = wet)")
    ap.add_argument("--form", default="ring",
                    choices=("ring", "shift", "nupols"),
                    help="FDL form; nupols = the two-level Gardner "
                         "long-IR scheme (--tail-chunk blocks/partition)")
    ap.add_argument("--tail-chunk", type=int, default=8)
    ap.add_argument("--out", default="bell_hall.wav")
    args = ap.parse_args(argv)

    from gpuaudiobench_jax.utils.data import reverb_impulse_responses

    dry = render_dry(args.seconds, args.modes, args.f0)
    ir = reverb_impulse_responses(1, max(BLOCK, int(args.rt60 * FS)))
    wet = stream_reverb(dry, ir, args.form, args.tail_chunk)

    # Stream == offline: one float64 FFT convolution of the whole take.
    n = len(wet)
    size = 1
    while size < n + ir.shape[1]:
        size <<= 1
    offline = np.fft.irfft(
        np.fft.rfft(dry[:n].astype(np.float64), size)
        * np.fft.rfft(ir[0].astype(np.float64), size), size)[:n]
    err = float(np.abs(wet - offline).max())
    peak = float(np.abs(offline).max()) or 1.0
    stream_ok = err <= 1e-4 * peak

    mixed = (1.0 - args.mix) * dry[:n] + args.mix * wet
    scale = float(np.abs(mixed).max()) or 1.0
    pcm = (np.clip(mixed / scale, -1, 1) * 32767.0).astype("<i2")
    with wave.open(args.out, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(FS)
        w.writeframes(pcm.tobytes())

    print(f"wrote {args.out}: {n / FS:.2f} s, rt60 {args.rt60:.2f} s "
          f"({ir.shape[1]} taps = "
          f"{-(-ir.shape[1] // BLOCK)} partitions, {args.form} FDL), "
          f"mix {args.mix}")
    print(f"streamed convolution matches offline: {stream_ok} "
          f"(max err {err:.2e} vs peak {peak:.3f})")
    return 0 if stream_ok else 1


if __name__ == "__main__":
    sys.exit(main())
