"""Render a struck bell to a WAV file with the modal synthesis engine,
streaming block-by-block with carried phasor state, a second strike
injected mid-stream, and a checkpoint/resume bit-equality proof.

This is the *user-facing* shape of the suite's flagship workload
(ModalFilterBank, the DAFx-24 poster's tab4 headline): the benchmark
measures this exact per-block step; here it makes sound. Everything
used below is public API:

  * ops.modal_triton.modal_step / ops.modal.modal_bank_xla -- the
    chainable one-block step (the Triton kernel on the GPU, the XLA
    scan elsewhere; same carry layout either way: amp-prefolded
    phasor (re, im)).
  * harness.checkpoint.save_stream_state / load_stream_state -- the
    structure-validated .npz persistence the soak harness uses
    (docs/API.md "Streaming state: checkpoint / resume").

Run:  python examples/streaming_synth.py [--seconds 4] [--modes 2048]
                                         [--out bell.wav]
The render finishes, then the second half is re-rendered from the
mid-stream checkpoint and compared bit-for-bit -- the same guarantee
tools/soak.py --resume relies on.
"""

from __future__ import annotations

import argparse
import os
import sys
import wave

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FS = 48_000
BLOCK = 512  # samples per streamed block (the benchmark's default)


def bell_modes(n_modes: int, f0: float = 220.0, seed: int = 7):
    """Inharmonic struck-bell bank: partials at f0*k*sqrt(1+B*k^2)
    (stiff-string/bell stretching), 1/f amplitude rolloff, faster decay
    for higher partials, and a cluster of micro-detuned modes per
    partial for shimmer. Returns (amp, cos_w, sin_w, re0, im0) float32.

    Decay is encoded in the ROTATION MAGNITUDE: the benchmark's bank
    rotates by a unit phasor (sustained sinusoids, Metal parity); a
    musical voice uses |rotation| = exp(-1/(FS*tau)) < 1 so each mode
    rings down exponentially. The kernel is agnostic to the magnitude.
    """
    g = np.random.default_rng(seed)
    per = max(1, n_modes // 32)  # micro-modes per partial
    k = np.repeat(np.arange(1, n_modes // per + 1), per)[:n_modes]
    detune = 1.0 + 0.0012 * g.standard_normal(n_modes)  # ~2 cents spread
    freq = f0 * k * np.sqrt(1.0 + 1.2e-4 * k * k) * detune
    freq = np.clip(freq, 20.0, 0.45 * FS)  # keep below the fold
    amp = (1.0 / k ** 1.1) * (0.7 + 0.6 * g.random(n_modes))
    tau = 5.0 / (1.0 + 0.12 * k)  # seconds to 1/e, shorter up high
    r = np.exp(-1.0 / (FS * tau))
    w = 2.0 * np.pi * freq / FS
    phase = 2.0 * np.pi * g.random(n_modes)
    return (
        amp.astype(np.float32),
        (r * np.cos(w)).astype(np.float32),
        (r * np.sin(w)).astype(np.float32),
        np.cos(phase).astype(np.float32),
        np.sin(phase).astype(np.float32),
    )


def make_stream(amp, cos_w, sin_w, re0, im0):
    """Backend-portable chainable block step.

    Returns (step, carry0) where step(carry) -> (carry', block (S,))
    -- the same contract as the harness's stream_body
    (models/modal.py), with the audio block in place of the probe.
    The carry is the amp-prefolded phasor on BOTH paths so a
    checkpoint written on one backend restores on the other.
    """
    import jax

    from gpuaudiobench_jax.utils import device as dev

    carry0 = (amp * re0, amp * im0)
    if dev.platform() == "gpu":
        from gpuaudiobench_jax.ops.modal_triton import modal_step
    else:
        from gpuaudiobench_jax.ops.modal import modal_bank_xla

        def modal_step(cos_w, sin_w, re, im, s, t):
            return modal_bank_xla(None, cos_w, sin_w, re, im, s, t)

    def step(carry):
        re, im = carry
        out_ts, re2, im2 = modal_step(cos_w, sin_w, re, im, BLOCK, 1)
        return (re2, im2), out_ts[0]

    import functools

    @functools.partial(jax.jit, static_argnums=1)
    def run_blocks(carry, n):
        def body(c, _):
            c2, block = step(c)
            return c2, block
        return jax.lax.scan(body, carry, None, length=n)

    return run_blocks, carry0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--modes", type=int, default=2048)
    ap.add_argument("--out", default="bell.wav")
    ap.add_argument("--f0", type=float, default=220.0)
    args = ap.parse_args(argv)

    from gpuaudiobench_jax.harness.checkpoint import (
        load_stream_state,
        save_stream_state,
    )

    amp, cos_w, sin_w, re0, im0 = bell_modes(args.modes, args.f0)
    run_blocks, carry = make_stream(amp, cos_w, sin_w, re0, im0)
    # Strike #2 excites the same modes with FRESH random phases (a real
    # mallet does not reproduce the first strike's phase alignment --
    # re-adding the initial phasors verbatim comb-filters against the
    # rotated state and can subtract energy). Deterministic seed, so the
    # resume proof still reproduces it exactly.
    g2 = np.random.default_rng(11)
    ph2 = 2.0 * np.pi * g2.random(args.modes).astype(np.float32)
    strike = (amp * np.cos(ph2).astype(np.float32),
              amp * np.sin(ph2).astype(np.float32))

    n_blocks = max(2, int(args.seconds * FS / BLOCK))
    half = n_blocks // 2
    ckpt = os.path.splitext(args.out)[0] + ".state.npz"

    # First half, then persist the carry exactly at the block boundary.
    carry, first = run_blocks(carry, half)
    save_stream_state(ckpt, carry, benchmark="streaming_synth_example")

    # Second strike lands at the checkpoint boundary: a resumed render
    # must reproduce it, so inject AFTER the save (deterministic carry
    # arithmetic, same on resume).
    import jax

    carry = jax.tree.map(lambda c, s: c + 0.7 * s, carry, strike)
    carry, second = run_blocks(carry, n_blocks - half)
    audio = np.concatenate([np.asarray(first).ravel(),
                            np.asarray(second).ravel()])

    # Resume proof: restore the boundary state and re-render the second
    # half; float op order is identical, so the tail must match BIT FOR
    # BIT (the guarantee tools/soak.py --resume relies on).
    template = jax.tree.map(np.zeros_like, strike)
    restored, _ = load_stream_state(ckpt, template,
                                    benchmark="streaming_synth_example")
    restored = jax.tree.map(lambda c, s: c + 0.7 * s, restored, strike)
    _, second_again = run_blocks(restored, n_blocks - half)
    resumed_ok = np.array_equal(np.asarray(second_again).ravel(),
                                audio[half * BLOCK:])

    peak = float(np.abs(audio).max()) or 1.0
    pcm = (np.clip(audio / peak, -1, 1) * 32767.0).astype("<i2")
    with wave.open(args.out, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(FS)
        w.writeframes(pcm.tobytes())

    dur = len(audio) / FS
    print(f"wrote {args.out}: {dur:.2f} s, {args.modes} modes, "
          f"peak {peak:.3f}, strike #2 at {half * BLOCK / FS:.2f} s")
    print(f"checkpoint/resume bit-exact: {resumed_ok} ({ckpt})")
    return 0 if resumed_ok else 1


if __name__ == "__main__":
    sys.exit(main())
