"""Sustained-load soak: continuous streaming for N seconds of audio.

The suite's saturated pass measures steady-state cost over a few
hundred blocks; this drives a streaming workload CONTINUOUSLY -- one
second of audio (ceil(fs/S) blocks) per executable, state carried
across every block -- and records per-second wall cost, deadline
misses, and thermal/clock drift over minutes, plus an
output-integrity probe (the signal's RMS must stay bounded: a
diverging recurrence or state corruption shows up as RMS blow-up or
collapse).

Two integrity signals per second, both outside the timed region:

* **probe RMS** -- mean |output| per block (harness/streaming.probe),
  stacked by the scan. For DWG this is structurally zero: the
  reference's own kernel (bench_dwg.cu:30-57) confines energy to
  closed (fwd[c], bwd[c+L/2]) cell pairs and reads the output at a
  pair the injection never touches, so |output| == 0 by construction
  (faithfully reproduced here; see models/dwg.py).
* **state RMS** -- RMS over the EVOLVING floating-point leaves of the
  CARRY, computed on-device (one scalar D2H). Leaves still
  bit-identical to their initial value (input blocks, sample pools,
  IR spectra riding the carry as aliased runtime arguments, so they
  stay out of the compiled module) are excluded per measurement so a large
  carried constant cannot dilute a genuine recurrence drift; if no
  leaf has evolved, the full-carry RMS is reported instead. This is
  the signal that actually detects a diverging recurrence or state
  corruption, and it stays live even when the audible output is
  silent or zero.

`reexcite_every=N` additionally re-injects 0.5x the benchmark's
INITIAL carry into every floating-point state leaf every N seconds
(integer leaves -- playheads, counters -- are left alone): a fresh
pluck, useful to confirm the state responds to new energy mid-soak.

Usage: python tools/soak.py [seconds] [output.md] [benchmark] [tracks]
           [--set FIELD=VALUE ...]   # BenchConfig overrides
                            [reexcite_every] [--checkpoint PATH]
                            [--resume] [--renorm]
       (defaults: 60s, soak.md, ModalFilterBank, 1024,
        0 = never re-excite)

``--checkpoint PATH`` saves the streaming carry every 30 soak seconds
and at the end (harness/checkpoint.py, .npz); with ``--resume`` the
soak restores the carry from PATH first -- a kill mid-soak loses at
most 30 s of state evolution, and a synthesis service restart
continues the same strings/phasors/fields instead of silence.
"""

from __future__ import annotations

import _pathfix  # noqa: F401,E402 - repo-root sys.path (tools/_pathfix.py)

import os
import sys
import time


def stream_state_rms(c, c0):
    """RMS over the carry's EVOLVING float leaves only. Constants
    ride the carry so they stay runtime arguments instead of
    compiled-module constants (models/iir.py), and an
    input block can outweigh the real state by 100x+ (IIR: T*S input
    vs T*2 z's) -- averaging it in would dilute a genuine drift below
    visibility. A leaf still bit-identical to its initial value is
    such a constant (or un-evolved state, which contributes nothing
    to drift either way); the exclusion is decided per measurement
    on-device. If NO leaf has evolved (stateless carry), fall back to
    the full-carry RMS so the artifact still reports a live, flat
    magnitude. Jit with c0 as an ARGUMENT, not a closure: capturing
    it would embed the pool/input constants into this module too."""
    import jax
    import jax.numpy as jnp

    pairs = [
        (jnp.asarray(a), jnp.asarray(b))
        for a, b in zip(jax.tree_util.tree_leaves(c),
                        jax.tree_util.tree_leaves(c0))
        if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating)
    ]
    if not pairs:
        return jnp.float32(0.0)
    zero = jnp.float32(0.0)
    sq_all = n_all = sq_ev = n_ev = zero
    for a, b in pairs:
        sq = jnp.sum(jnp.square(a).astype(jnp.float32))
        n = jnp.float32(a.size)
        evolved = ~jnp.array_equal(a, b)
        sq_all, n_all = sq_all + sq, n_all + n
        sq_ev = sq_ev + jnp.where(evolved, sq, zero)
        n_ev = n_ev + jnp.where(evolved, n, zero)
    return jnp.where(
        n_ev > 0,
        jnp.sqrt(sq_ev / jnp.maximum(n_ev, 1.0)),
        jnp.sqrt(sq_all / n_all),
    )


def main() -> int:
    argv = list(sys.argv[1:])
    ckpt_path = None
    resume = False
    if "--resume" in argv:
        argv.remove("--resume")
        resume = True
    if "--checkpoint" in argv:
        i = argv.index("--checkpoint")
        if i + 1 >= len(argv) or argv[i + 1].startswith("--"):
            print("--checkpoint requires a PATH argument")
            return 1
        ckpt_path = argv[i + 1]
        del argv[i:i + 2]
    renorm = False
    if "--renorm" in argv:
        argv.remove("--renorm")
        renorm = True
    overrides = []
    while "--set" in argv:  # BenchConfig overrides, as tools/capacity.py
        i = argv.index("--set")
        if i + 1 >= len(argv):
            print("--set requires a FIELD=VALUE argument")
            return 1
        overrides.append(argv[i + 1])
        del argv[i:i + 2]
    if resume and not ckpt_path:
        print("--resume requires --checkpoint PATH")
        return 1
    seconds = int(argv[0]) if len(argv) > 0 else 60
    out_path = argv[1] if len(argv) > 1 else "soak.md"
    name = argv[2] if len(argv) > 2 else "ModalFilterBank"
    tracks = int(argv[3]) if len(argv) > 3 else 1024
    reexcite_every = int(argv[4]) if len(argv) > 4 else 0
    if renorm and reexcite_every:
        # Renorm pins magnitudes to their initial values, so it would
        # cancel the re-excitation's injected amplitude one block
        # later -- the probe would (correctly but uselessly) read the
        # state as unresponsive. Semantically incompatible; fail fast.
        print("--renorm and reexcite_every are mutually exclusive: "
              "renorm pins magnitudes to their INITIAL values and "
              "would erase the injected energy on the next block")
        return 1

    import jax
    import numpy as np

    from gpuaudiobench_jax.config import BenchConfig
    from gpuaudiobench_jax.registry import create_benchmark
    from gpuaudiobench_jax.utils.device import enable_compilation_cache

    enable_compilation_cache()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from capacity import parse_overrides

    cfg = BenchConfig(
        n_tracks=tracks,
        n_runs=1, warmup=1, write_latencies=False, device_timing=False,
        verification="none", modal_renorm=renorm,
        **parse_overrides(overrides),
    )
    bench = create_benchmark(name, cfg)
    bench.setup()
    body = bench.stream_body()
    step_fn, carry = body if body is not None else (None, None)
    s = cfg.buffer_size
    blocks_per_sec = -(-cfg.fs // s)  # 94 at 48k/512
    deadline_ms = cfg.deadline_ms()

    @jax.jit
    def one_second(c):
        def f(c, _):
            c2, probe = step_fn(c)
            return c2, probe
        c, probes = jax.lax.scan(f, c, None, length=blocks_per_sec)
        return c, probes

    if step_fn is None:
        print(f"{name} has no streaming mode; nothing to soak")
        return 1
    carry0 = carry  # initial state, kept for re-excitation
    if resume:
        from gpuaudiobench_jax.harness.checkpoint import load_stream_state

        carry, hdr = load_stream_state(ckpt_path, carry, benchmark=name)
        print(f"resumed carry from {ckpt_path} "
              f"(saved {hdr.get('saved_at')}, "
              f"{hdr.get('extra', {}).get('soak_seconds', '?')} soak s)")

    def reexcite(c):
        import jax.numpy as jnp

        def mix(a, b):
            a_ = jnp.asarray(a)
            if not jnp.issubdtype(a_.dtype, jnp.floating):
                return a
            # Pass-through constants (mode tables, IR spectra, sample
            # pools) ride the carry unchanged so they stay runtime
            # arguments instead of module constants; re-exciting
            # them would corrupt the PROGRAM, not the state. A leaf
            # still bit-identical to its initial value is such a
            # constant (or un-evolved state, for which +0.5*initial is
            # the identity anyway). Runs outside the timed region.
            if bool(jnp.array_equal(a_, jnp.asarray(b))):
                return a
            return (a_ + 0.5 * jnp.asarray(b)).astype(a_.dtype)

        return jax.tree.map(mix, c, carry0)

    state_rms = jax.jit(stream_state_rms)  # see module-level docstring

    # compile + warm
    carry, probes = one_second(carry)
    _ = np.asarray(probes)

    rows = []
    print(f"soaking {seconds}s of audio ({name}, {tracks} tracks, "
          f"{blocks_per_sec} blocks/s)...")
    for sec in range(seconds):
        if reexcite_every and sec and sec % reexcite_every == 0:
            carry = reexcite(carry)  # outside the timed region
        t0 = time.perf_counter()
        carry, probes = one_second(carry)
        probes_h = np.asarray(probes)  # real D2H sync
        wall = (time.perf_counter() - t0) * 1000.0
        per_block = wall / blocks_per_sec
        rms = float(np.sqrt(np.mean(probes_h.astype(np.float64) ** 2)))
        srms = float(state_rms(carry, carry0))  # outside timed region
        rows.append((sec, wall, per_block, rms, srms))
        if ckpt_path and (sec % 30 == 29 or sec == seconds - 1):
            from gpuaudiobench_jax.harness.checkpoint import (
                save_stream_state,
            )

            save_stream_state(  # outside the timed region
                ckpt_path, carry, benchmark=name,
                extra={"soak_seconds": sec + 1, "tracks": tracks},
            )
        if sec % 10 == 0 or per_block > deadline_ms:
            print(f"  t={sec:4d}s wall={wall:8.2f} ms "
                  f"({per_block:.3f} ms/block) probe_rms={rms:.4g} "
                  f"state_rms={srms:.4g}")

    per_block = np.array([r[2] for r in rows])
    rms = np.array([r[3] for r in rows])
    srms = np.array([r[4] for r in rows])
    misses = int((per_block > deadline_ms).sum())
    # Thermal/clock drift over the soak, endpoint-noise-robust: median
    # of the first vs last W per-second averages (a single slow host
    # second at either end must not dominate the headline).
    win = max(1, min(10, seconds // 4))
    drift_pct = (np.median(per_block[-win:])
                 / np.median(per_block[:win]) - 1) * 100
    from gpuaudiobench_jax.utils import device as dev

    lines = [
        f"# Sustained-load soak ({dev.default_device().device_kind}; "
        f"{dev.card_info() or 'no nvidia-smi'}): {name} "
        f"({tracks} tracks), continuous",
        "",
        f"{seconds} seconds of audio processed block-by-block with "
        "carried state",
        f"({blocks_per_sec} x 512-sample blocks per second, one "
        "executable per second of audio,",
        "timed through a real D2H read). Generated by `tools/soak.py`.",
        "",
        "| metric | value |",
        "|---|---:|",
        f"| seconds of audio | {seconds} |",
        f"| mean ms/block | {per_block.mean():.4f} |",
        f"| p50 / p95 / max ms/block (per-second averages) | "
        f"{np.percentile(per_block, 50):.4f} / "
        f"{np.percentile(per_block, 95):.4f} / {per_block.max():.4f} |",
        f"| seconds over the {deadline_ms:.3f} ms/block deadline | "
        f"{misses} |",
        f"| drift, median of first {win} s -> last {win} s | "
        f"{drift_pct:+.2f}% |",
        f"| probe RMS first / last (output liveness) | "
        f"{rms[0]:.4g} / {rms[-1]:.4g} |",
        f"| state RMS first / last (carry integrity) | "
        f"{srms[0]:.4g} / {srms[-1]:.4g} |",
        f"| state RMS min / max over the soak | "
        f"{srms.min():.4g} / {srms.max():.4g} |",
    ]
    if reexcite_every:
        lines.append(
            f"| re-excitation (0.5x initial state into float leaves) | "
            f"every {reexcite_every} s |")
    if renorm:
        lines.append(
            "| phasor magnitude renorm (--modalRenorm) | every block |")
    if name.startswith("DWG") and rms.max() == 0.0:
        lines += [
            "",
            "Probe RMS 0 is STRUCTURAL for DWG, not a dead stream: the",
            "reference's update reads and writes the same cell pair per",
            "sample (bench_dwg.cu:372-390, writePos never advances), so",
            "the output-tap cells form a closed zero-energy system and",
            "the tap output is identically zero by construction (see",
            "models/dwg.py dwg_reference docstring; test-pinned).",
            "Liveness for DWG is the state-RMS row above.",
        ]
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")

    csv_path = os.path.splitext(out_path)[0] + ".csv"
    if csv_path == out_path:  # extensionless out_path
        csv_path = out_path + ".csv"
    with open(csv_path, "w") as f:
        f.write("second,wall_ms,ms_per_block,probe_rms,state_rms\n")
        for sec, wall, pb, r, sr in rows:
            f.write(f"{sec},{wall:.4f},{pb:.6f},{r:.6g},{sr:.6g}\n")
    print(f"written: {out_path} + {csv_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
