"""Scale the bell across a device mesh: mode-sharded modal synthesis.

The single-device example (examples/streaming_synth.py) streams a
2048-mode bell; this one shards the MODE axis of the same bank over
every available device (the "tp" axis of the suite's mesh,
parallel/mesh.py) and psum-reduces each block's partial output across
the mesh -- the pattern MultiChipSuite benchmarks, here as plain
user-facing API:

  * each device holds modes [i*M/n, (i+1)*M/n) as amp-prefolded
    phasors (a NamedSharding over the mode axis -- XLA moves nothing),
  * per block every device rotates only its own modes and contributes
    a partial (S,) buffer,
  * one psum over "tp" per block (S floats -- the link traffic is the
    OUTPUT, tiny, not the mode state).

Runs on anything: real GPUs, or a virtual CPU mesh --

  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python examples/multichip_synth.py --seconds 2 --out bell8.wav

The render is verified against a single-device render of the same
bank (tolerance-checked: psum changes the f32 summation order, so
equality is ~1e-6 relative, not bit-exact).
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
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--modes", type=int, default=4096)
    ap.add_argument("--out", default="bell_mesh.wav")
    args = ap.parse_args(argv)

    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from examples.streaming_synth import bell_modes
    from gpuaudiobench_jax.ops.modal import modal_bank_xla

    n_dev = len(jax.devices())
    if args.modes % n_dev:
        raise SystemExit(f"--modes must divide by {n_dev} devices")
    mesh = Mesh(np.asarray(jax.devices()), axis_names=("tp",))

    amp, cos_w, sin_w, re0, im0 = bell_modes(args.modes)
    ones = np.ones_like(amp)

    # Shard every per-mode array over "tp"; the carry stays sharded for
    # the whole render (mode state never crosses the links).
    shard = NamedSharding(mesh, P("tp"))
    cos_d = jax.device_put(cos_w, shard)
    sin_d = jax.device_put(sin_w, shard)
    carry = (jax.device_put(amp * re0, shard),
             jax.device_put(amp * im0, shard))

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("tp"), P("tp"), (P("tp"), P("tp"))),
        out_specs=(P(), (P("tp"), P("tp"))),
    )
    def block_step(cos_l, sin_l, carry_l):
        re, im = carry_l
        out_ts, re2, im2 = modal_bank_xla(
            jnp.ones_like(re), cos_l, sin_l, re, im, BLOCK, 1
        )
        # one psum of S floats per block: the only cross-device traffic
        return jax.lax.psum(out_ts[0], "tp"), (re2, im2)

    n_blocks = max(1, int(args.seconds * FS / BLOCK))

    @functools.partial(jax.jit, static_argnums=1)
    def run_blocks(carry, n):
        def body(c, _):
            blk, c2 = block_step(cos_d, sin_d, c)
            return c2, blk
        return jax.lax.scan(body, carry, None, length=n)

    carry, blocks = run_blocks(carry, n_blocks)
    audio = np.asarray(blocks).ravel()

    # Single-device cross-check of the full render.
    re, im = amp * re0, amp * im0
    golden = []
    for _ in range(n_blocks):
        out_ts, re, im = modal_bank_xla(ones, cos_w, sin_w, re, im, BLOCK, 1)
        golden.append(np.asarray(out_ts[0]))
    golden = np.concatenate(golden)
    scale = float(np.abs(golden).max()) or 1.0
    max_rel = float(np.abs(audio - golden).max()) / scale
    ok = max_rel < 1e-5  # f32 psum reorders the mode sum

    peak = float(np.abs(audio).max()) or 1.0
    pcm = (np.clip(audio / peak, -1, 1) * 32767.0).astype("<i2")
    with wave.open(args.out, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(FS)
        w.writeframes(pcm.tobytes())

    print(f"wrote {args.out}: {len(audio) / FS:.2f} s, {args.modes} modes "
          f"sharded over {n_dev} device(s) [mesh axis tp]")
    print(f"matches single-device render: {ok} "
          f"(max rel err {max_rel:.2e} vs peak)")

    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
