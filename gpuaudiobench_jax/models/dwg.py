"""DWG1DNaive / DWG1DAccel: digital-waveguide strings
(cuda/bench_dwg.cu). nTracks waveguides, delay-line rails of max length
2000 with random lengths 100-2000, taps at L/4 and 3L/4, gain
0.1 + 0.9u, reflection 0.99 +- 0.005, damping 0.9999 +- 5e-5, seed 42
(bench_dwg.cu:325-348); mono bufferSize output summed over all
waveguides; abs tolerance 1e-2 (bench_dwg.cu:270).

The "accel" variant rounds delay lengths down to powers of two (the
CUDA accel kernel's bit-mask fast path, bench_dwg.cu:91-111; Metal's
aligned length distribution, DWG1DAccelBenchmark.swift:15-86) -- here
both variants run the same arc-window block (ops/dwg_arc.py) with
different lengths.

State semantics: like the reference, the evolved rails round-trip
host<->device every iteration (bench_dwg.cu:203-247) so the strings keep
ringing across blocks (writePos stays 0; each block re-walks positions
0..S-1 over the evolved rails, bench_dwg.cu:339). Unlike the reference
-- whose golden is a single pass from silence, making its check
time-dependent -- validation here runs the NumPy reference once per
performed iteration and compares the LAST block, so the carried-state
behavior is what actually gets validated.

Known reference quirk, reproduced faithfully: the OUTPUT of this
benchmark is structurally zero. In the reference kernel
(bench_dwg.cu:30-57) each sample touches only the cell pair
(fwd[c], bwd[(c+L/2) % L]) at c = (writePos+n) % L, and the
cross-reflection writes stay within that pair -- the position space
decomposes into closed 2-cycles that never exchange energy. Input is
injected into the c == inputTap pair, the output is read from the
c == outputTap pair (3L/4 != L/4), so the out-tap pair stays
identically zero forever while the in-tap pair rings at its
injection/damping equilibrium. Every FLOP still executes (the work is
data-independent), so the TIMING is a valid waveguide-update cost;
correctness is evidenced by the rails comparison (which carries real
energy), not the all-zero output, and soak integrity (tools/soak.py)
probes the carry RMS for the same reason.
"""

from __future__ import annotations

import numpy as np

from gpuaudiobench_jax.config import BenchConfig
from gpuaudiobench_jax.harness.base import Benchmark
from gpuaudiobench_jax.harness.validation import ValidationData, compare_abs
from gpuaudiobench_jax.ops.dwg_arc import (
    dwg_block_arc,
    dwg_stream_entry,
    dwg_stream_step,
)
from gpuaudiobench_jax.utils import device as dev

MIN_LENGTH = 100  # bench_dwg.cuh DEFAULT_MIN_LENGTH
MAX_LENGTH = 2000  # bench_dwg.cuh DEFAULT_MAX_LENGTH
REFLECTION = 0.99
DAMPING = 0.9999
MIX_FACTOR = 0.5  # benchmark_constants.cuh WAVEGUIDE_MIX_FACTOR


def dwg_reference(x, fwd, bwd, lengths, in_taps, out_taps, gains, refl, damp):
    """Float32 one-block golden, vectorized over waveguides
    (bench_dwg.cu:356-399); returns (out, fwd', bwd') so repeated calls
    reproduce the reference's carried-rails evolution.

    Structural property of the reference's update (faithfully kept
    here, pinned by test_ops.py::test_dwg_output_structurally_zero):
    sample n reads AND writes the same cell pair
    ``(fwd[p], bwd[(p + L//2) % L])`` with ``p = n % L``
    (bench_dwg.cu:372-390 -- writePos is set once to 0,
    bench_dwg.cu:338, and never advanced), so each pair is a closed
    2-cell oscillator: energy injected at the input-tap pair
    (p = L/4) can never reach the output-tap pair (p = 3L/4), and the
    summed tap OUTPUT is identically zero for every waveguide,
    forever.  The benchmark's real signal lives in the rails -- which
    is why ``validate()`` compares the carried rails against the
    golden's, not just the (vacuously matching) output block, and why
    soak liveness for DWG is state RMS, not output-probe RMS.
    """
    fwd = fwd.copy()
    bwd = bwd.copy()
    g = fwd.shape[0]
    rows = np.arange(g)
    half = lengths // 2
    out = np.zeros(x.shape[0], np.float32)
    for n in range(x.shape[0]):
        cur = n % lengths
        bpos = (cur + half) % lengths
        f = fwd[rows, cur] * damp
        b = bwd[rows, bpos] * damp
        inj = np.where(cur == in_taps, np.float32(x[n]) * gains, np.float32(0))
        f = f + inj
        b = b + inj
        fwd[rows, cur] = b * refl
        bwd[rows, bpos] = f * refl
        out[n] = np.sum(
            np.where(cur == out_taps, (f + b) * np.float32(MIX_FACTOR), np.float32(0))
        )
    return out, fwd, bwd


class DWGBenchmark(Benchmark):
    name = "DWG1DNaive"
    tolerance = 1e-2  # bench_dwg.cu:270

    def __init__(self, cfg: BenchConfig, accelerated: bool = False):
        super().__init__(cfg)
        self.accelerated = accelerated
        if accelerated:
            self.name = "DWG1DAccel"

    def setup(self) -> None:
        g = np.random.Generator(np.random.MT19937(self.cfg.seed))
        n_wg = self.track_count
        lo = self.cfg.dwg_min_length
        hi = self.cfg.dwg_max_length
        self._max_len = hi
        lengths = lo + g.integers(0, max(1, hi - lo), n_wg)
        if self.accelerated:
            # Round down to powers of two (>= 128 given MIN_LENGTH=100).
            lengths = (2 ** np.floor(np.log2(lengths))).astype(np.int64)
        self.lengths = lengths.astype(np.int32)
        self.in_taps = (self.lengths // 4).astype(np.int32)
        self.out_taps = (3 * self.lengths // 4).astype(np.int32)
        self.gains = (0.1 + 0.9 * g.random(n_wg, dtype=np.float32)).astype(np.float32)
        self.refl = (
            REFLECTION + 0.01 * (g.random(n_wg, dtype=np.float32) - 0.5)
        ).astype(np.float32)
        self.damp = (
            DAMPING + 0.0001 * (g.random(n_wg, dtype=np.float32) - 0.5)
        ).astype(np.float32)
        self.host_input = (
            g.random(self.buffer_size, dtype=np.float32) * 2 - 1
        ).astype(np.float32)

        # Stable partition: waveguides with L >= bufferSize first. The
        # arc-window block (ops/dwg_arc.py) handles long rows with a
        # fully-parallel elementwise path and needs the split to be a
        # static row boundary. A pure relabeling: the mono output sum
        # and the per-row rail validation use the permuted parameters
        # consistently. Applied after all RNG draws so the sampled
        # values match the reference's stream.
        order = np.argsort(self.lengths < self.buffer_size, kind="stable")
        self.lengths = self.lengths[order]
        self.in_taps = self.in_taps[order]
        self.out_taps = self.out_taps[order]
        self.gains = self.gains[order]
        self.refl = self.refl[order]
        self.damp = self.damp[order]
        self._n_long = int((self.lengths >= self.buffer_size).sum())
        shorts = self.lengths[self.lengths < self.buffer_size]
        self._n_rounds = (
            int(-(-self.buffer_size // int(shorts.min()))) if shorts.size else 0
        )

        self.setup_sharding(n_wg, "waveguides (nTracks)")
        self._zero_rails = np.zeros((n_wg, self._max_len), np.float32)
        self.track_alloc("delayRails", self._zero_rails.nbytes * 4)  # fwd+bwd, host+dev
        self.track_alloc("ioBuffers", self.buffer_size * 4 * 4)
        self._consts = {
            "lengths": self.put_sharded(self.lengths),
            "in_taps": self.put_sharded(self.in_taps),
            "out_taps": self.put_sharded(self.out_taps),
            "gains": self.put_sharded(self.gains),
            "refl": self.put_sharded(self.refl),
            "damp": self.put_sharded(self.damp),
        }
        self._resident_input = self.put_replicated(self.host_input)
        self._resident_rails = (
            self.put_sharded(self._zero_rails),
            self.put_sharded(self._zero_rails),
        )

        self.host_output = None
        self.host_fwd = self._zero_rails.copy()
        self.host_bwd = self._zero_rails.copy()
        self._invocations = 0

        # Single-transfer readback: pack mono output + both rails.
        import jax
        import jax.numpy as jnp

        def _step(x, fwd, bwd):
            out, fwd_o, bwd_o = self._run(x, fwd, bwd)
            return jnp.concatenate([out, fwd_o.ravel(), bwd_o.ravel()])

        self._step = jax.jit(_step)
        self.iterate()

    def _run(self, x, fwd, bwd):
        c = self._consts
        return dwg_block_arc(
            x, fwd, bwd, c["lengths"], c["in_taps"], c["out_taps"],
            c["gains"], c["refl"], c["damp"],
            n_long=self._n_long, n_rounds=self._n_rounds,
        )

    def iterate(self) -> None:
        # Upload input + the EVOLVED rails; download them back (the
        # reference moves rails both ways every iteration,
        # bench_dwg.cu:203-247) -- the strings ring across blocks.
        x = self.put_replicated(self.host_input)
        fwd = self.put_sharded(self.host_fwd)
        bwd = self.put_sharded(self.host_bwd)
        buf = dev.from_device(self._step(x, fwd, bwd))
        s = self.buffer_size
        rails = self.track_count * self._max_len
        self.host_output = buf[:s]
        self.host_fwd = buf[s:s + rails].reshape(self.track_count, self._max_len)
        self.host_bwd = buf[s + rails:].reshape(self.track_count, self._max_len)
        self._invocations += 1

    def device_iterate(self) -> None:
        out, _, _ = self._run(self._resident_input, *self._resident_rails)
        dev.block(out)

    def overlap_body(self):
        """Input upload double-buffered against the rail update; the
        rails themselves carry on-device (the streaming dependency)."""
        step = self._step
        s = self.buffer_size
        rails = self.track_count * self._max_len
        t, m = self.track_count, self._max_len

        def f(x, carry):
            fwd, bwd = carry
            buf = step(x, fwd, bwd)
            return buf[:s], (buf[s:s + rails].reshape(t, m),
                             buf[s + rails:].reshape(t, m))

        import numpy as _np

        return (f, [self.host_input, _np.negative(self.host_input)],
                (self.put_sharded(self.host_fwd),
                 self.put_sharded(self.host_bwd)))

    def stream_body(self):
        from gpuaudiobench_jax.harness.streaming import probe

        x, c = self._resident_input, self._consts
        # Streaming carries the ALIGNED stored-value form: the
        # positional scatter of block k cancels against block k+1's
        # gather, so long rows chain with zero rolls
        # (ops/dwg_arc.py dwg_stream_step).
        sf0, sb0 = dwg_stream_entry(
            self.host_fwd, self.host_bwd, self.lengths, self.buffer_size
        )
        n_long, n_rounds = self._n_long, self._n_rounds

        # Excitation block in the carry (aliased), not the closure
        # (models/iir.py stream_body); the per-voice const rows
        # (~24 B/voice) stay closures.
        def step(carry):
            xc, sf, sb = carry
            out, sf, sb = dwg_stream_step(
                xc, sf, sb, c["lengths"], c["in_taps"], c["out_taps"],
                c["gains"], c["refl"], c["damp"],
                n_long=n_long, n_rounds=n_rounds,
            )
            return (xc, sf, sb), probe(out)

        return step, (
            x, self.put_sharded(sf0), self.put_sharded(sb0)
        )

    def validate(self) -> ValidationData:
        if self.cfg.verification == "none":
            return compare_abs(
                self.host_output, self.host_output, self.tolerance,
                mode="none", label=self.name,
            )
        # Golden: run the NumPy reference once per performed iteration,
        # carrying the rails, and compare the final block.
        fwd = self._zero_rails.copy()
        bwd = self._zero_rails.copy()
        golden = None
        for _ in range(self._invocations):
            golden, fwd, bwd = dwg_reference(
                self.host_input, fwd, bwd,
                self.lengths, self.in_taps, self.out_taps,
                self.gains, self.refl, self.damp,
            )
        v = compare_abs(
            self.host_output, golden, self.tolerance,
            mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
            label=self.name,
        )
        v.merge_failure(
            compare_abs(
                self.host_fwd, fwd, self.tolerance,
                mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
                label=f"{self.name} rails",
            )
        )
        return v

    def cost_model(self):
        import numpy as np

        g, s = self.track_count, self.buffer_size
        touched = int(np.minimum(self.lengths, s).sum()) if hasattr(self, "lengths") \
            else g * min(self._max_len, s)
        return {
            "flops": 10 * g * s,
            "hbm_bytes": (2 * 2 * 2 * touched + 2 * s) * 4,  # 2 rails, r+w, +io
            "unit": "fp32",
        }

    def bytes_processed(self) -> int:
        # input + mono output + both rails in each direction
        rails = 2 * self.track_count * self._max_len * 4
        return self.buffer_size * 4 * 2 + 2 * rails

    def metadata(self):
        return {
            "numWaveguides": self.track_count,
            "maxLength": self._max_len,
            "variant": "accel" if self.accelerated else "naive",
        }
