"""Auralize the FDTD room: render its impulse response to a WAV file.

The FDTD3D benchmark times a 52-cell-cubed wave-equation room (3
leapfrog substeps per audio sample, reflective walls with a lossy
boundary ring -- ops/fdtd3d.py cites the reference kernel). This
example uses the same block step as a ROOM SIMULATOR: inject one
impulse at the source cell, keep stepping with silent input, and
record the receiver cell -- the room impulse response (RIR) that a
convolution reverb would apply. Echo density and ring-down come out
of the physics; nothing here is a designed filter.

The block is the benchmark's own XLA program; it carries the
(pressure, velocity) field state across blocks, exactly as the
benchmark's streaming mode does.

Run:  python examples/room_impulse.py [--seconds 1.0] [--out rir.wav]
"""

from __future__ import annotations

import argparse
import os
import sys
import wave

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FS = 48_000
BLOCK = 512


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default="rir.wav")
    args = ap.parse_args(argv)

    import functools

    import jax
    import jax.numpy as jnp

    from gpuaudiobench_jax.ops.fdtd3d import fdtd3d_block, zero_fields

    step_fn, fields = fdtd3d_block, zero_fields()

    n_blocks = max(1, int(args.seconds * FS / BLOCK))
    impulse = jnp.zeros((1, BLOCK), jnp.float32).at[0, 0].set(1.0)
    silence = jnp.zeros((1, BLOCK), jnp.float32)

    @functools.partial(jax.jit, static_argnums=1)
    def run(fields, n):
        def body(carry, _):
            out, *f2 = step_fn(silence, *carry)
            return tuple(f2), out[0]
        # block 0 carries the impulse; the rest ring down
        out0, *f1 = step_fn(impulse, *fields)
        f_final, rest = jax.lax.scan(body, tuple(f1), None, length=n - 1)
        return f_final, jnp.concatenate([out0[0][None], rest], axis=0)

    fields, blocks = run(fields, n_blocks)
    rir = np.asarray(blocks).ravel()

    # Physics sanity, printed for the curious: direct-path arrival and
    # decay. The receiver sits |SOURCE-RECEIVER| cells away; sound in
    # this discretization travels at most 1 cell per substep.
    nz = np.nonzero(np.abs(rir) > 1e-9 * np.abs(rir).max())[0]
    first = int(nz[0]) if len(nz) else -1
    half = len(rir) // 2
    e_early = float(np.sqrt(np.mean(rir[:half] ** 2)))
    e_late = float(np.sqrt(np.mean(rir[half:] ** 2)))

    peak = float(np.abs(rir).max()) or 1.0
    pcm = (np.clip(rir / peak, -1, 1) * 32767.0).astype("<i2")
    with wave.open(args.out, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(FS)
        w.writeframes(pcm.tobytes())

    print(f"wrote {args.out}: {len(rir) / FS:.2f} s room impulse response "
          f"(52^3 cells, 3 substeps/sample)")
    # Gate on STABILITY, not monotone decay: over short renders the
    # reflective room is still building echo density, so late RMS may
    # sit slightly above early RMS; a broken stencil blows up
    # exponentially instead (orders of magnitude, and non-finite fast).
    stable = bool(np.isfinite(rir).all()) and e_late < 5.0 * e_early
    print(f"direct path arrives at sample {first}; "
          f"early/late RMS = {e_early:.3e}/{e_late:.3e} "
          f"({'stable' if stable else 'UNSTABLE'})")
    return 0 if (first >= 0 and stable) else 1


if __name__ == "__main__":
    sys.exit(main())
