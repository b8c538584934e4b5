"""ModalFilterBank: phasor-rotation sinusoid bank.

Implements the REAL modal bank -- the Metal semantics
(kernels_benchmark_staging.metal:121-162, ModalFilterBankBenchmark.swift)
-- because the CUDA ModalSynthesisKernel is a documented stub that fills
constant output for the first 32 modes (bench_modal.cu:15-36,
SURVEY.md s7 divergence list).

Modes = min(1024 * nTracks, 1M) with 8 float params each (amp, freq,
phase, stateRe, stateIm, 3 reserved); per sample the complex state
rotates by e^{i*2*pi*freq} and amp*Re(state) accumulates into output
track (mode % outputTracks), outputTracks = min(nTracks, 32). Relative
tolerance 1e-4 (ModalFilterBankBenchmark.swift:167).

The rotation coefficients cos/sin(2*pi*f) are precomputed on host in
float32 and shipped once at setup, so device and golden rotate by
bit-identical factors (the Metal kernel also hoists them,
kernels_benchmark_staging.metal:143-145).

On the GPU each block is one Pallas kernel through Triton
(ops/modal_triton.py); on the CPU, where no Triton kernel compiles, it
is the XLA scan (ops/modal.py), which is also the kernel's reference.
"""

from __future__ import annotations

import numpy as np

from gpuaudiobench_jax.config import BenchConfig
from gpuaudiobench_jax.harness.base import Benchmark
from gpuaudiobench_jax.harness.validation import ValidationData, compare_rel
from gpuaudiobench_jax.utils import device as dev

NUM_MODE_PARAMS = 8


def _renorm_wrap(step, re0, im0):
    """Streaming-only magnitude renormalization (cfg.modal_renorm).

    The f32 phasor rotation is not exactly unitary: round-off compounds
    exponentially, faithful to the reference which never renormalizes
    (bench_modal.cu). This wrapper
    rescales each mode's phasor back to its INITIAL magnitude after
    every block -- phase (the musical content) is untouched, and the
    ~5 ops/mode cost is <0.2% of the rotation work -- making indefinite
    streaming drift-free.
    """
    import jax.numpy as jnp

    mag0 = jnp.sqrt(re0 * re0 + im0 * im0)
    tiny = jnp.float32(1e-30)

    def renorm_step(carry):
        carry2, out = step(carry)
        *consts, re, im = carry2
        mag = jnp.sqrt(re * re + im * im)
        scale = jnp.where(mag0 > 0, mag0 / jnp.maximum(mag, tiny),
                          jnp.float32(1.0))
        return (*consts, re * scale, im * scale), out

    return renorm_step


def modal_reference(
    amp: np.ndarray,
    cos_w: np.ndarray,
    sin_w: np.ndarray,
    state_re: np.ndarray,
    state_im: np.ndarray,
    buffer_size: int,
    output_tracks: int,
) -> np.ndarray:
    """Float64-accumulated iterative golden
    (ModalFilterBankBenchmark.swift:73-101)."""
    m = amp.shape[0]
    re = state_re.astype(np.float32).copy()
    im = state_im.astype(np.float32).copy()
    out = np.zeros((output_tracks, buffer_size), np.float64)
    groups = m // output_tracks
    amp64 = amp.astype(np.float64)
    for n in range(buffer_size):
        new_re = re * cos_w - im * sin_w
        new_im = re * sin_w + im * cos_w
        re, im = new_re, new_im
        contrib = (amp64 * re).reshape(groups, output_tracks).sum(axis=0)
        out[:, n] = contrib
    return out.astype(np.float32)


class ModalFilterBankBenchmark(Benchmark):
    name = "ModalFilterBank"
    tolerance = 1e-4  # relative (ModalFilterBankBenchmark.swift:167)

    def __init__(self, cfg: BenchConfig):
        super().__init__(cfg)
        self.num_modes = cfg.modal_num_modes or min(1024 * cfg.n_tracks, 1024 * 1024)
        self.output_tracks = min(cfg.n_tracks, 32)
        # Pad with zero-amplitude modes so modes fold evenly onto tracks.
        self.padded_modes = -(-self.num_modes // self.output_tracks) * self.output_tracks

    def setup(self) -> None:
        g = np.random.Generator(np.random.MT19937(self.cfg.seed))
        m, mp = self.num_modes, self.padded_modes
        amp = np.zeros(mp, np.float32)
        freq = np.zeros(mp, np.float32)
        self.phase = np.zeros(mp, np.float32)  # generated but unused (Metal parity)
        sre = np.zeros(mp, np.float32)
        sim = np.zeros(mp, np.float32)
        amp[:m] = g.random(m, dtype=np.float32)  # amp in [0,1)
        freq[:m] = g.random(m, dtype=np.float32) * 0.45  # freq in [0,0.45)
        self.phase[:m] = g.random(m, dtype=np.float32) * np.float32(2 * np.pi)
        sre[:m] = g.random(m, dtype=np.float32) * 2 - 1
        sim[:m] = g.random(m, dtype=np.float32) * 2 - 1

        w = (np.float32(2 * np.pi) * freq).astype(np.float32)
        cos_w = np.cos(w).astype(np.float32)
        sin_w = np.sin(w).astype(np.float32)

        self.params = {
            "amp": amp, "cos_w": cos_w, "sin_w": sin_w,
            "state_re": sre, "state_im": sim,
        }
        self.setup_sharding(mp, "modes (padded)")
        self._dev = {k: self.put_sharded(v) for k, v in self.params.items()}
        self.track_alloc("modeParams", self.num_modes * NUM_MODE_PARAMS * 4)
        self.track_alloc("outputBuffer", self.output_tracks * self.buffer_size * 4)
        # The golden iterates the full bank on the host (~linear in
        # modes; minutes at 10M+), so skip it when validation is off --
        # capacity probes (tools/capacity.py) search boundary sizes
        # with --verification none (DWG gates its golden the same way).
        self.golden = None
        if self.cfg.verification != "none":
            self.golden = modal_reference(
                amp, cos_w, sin_w, sre, sim,
                self.buffer_size, self.output_tracks,
            )
        self.host_output = None
        # pallas_call does not partition over a --dataParallel mesh, so
        # a sharded bank runs the XLA form.
        self._kernel = ("triton" if dev.platform() == "gpu"
                        and self.cfg.data_parallel == 1 else "xla")
        self.iterate()

    def _step(self, cos_w, sin_w, re_f, im_f):
        """One block on amp-prefolded states: (out (T, S), re', im')."""
        s, t = self.buffer_size, self.output_tracks
        if self._kernel == "triton":
            from gpuaudiobench_jax.ops.modal_triton import modal_step

            return modal_step(cos_w, sin_w, re_f, im_f, s, t)
        from gpuaudiobench_jax.ops.modal import modal_bank_xla

        return modal_bank_xla(None, cos_w, sin_w, re_f, im_f, s, t)

    def _run(self):
        # Metal parity: the kernel reads the state buffer but does not
        # write it back, so every iteration synthesizes the same block.
        d = self._dev
        return self._step(d["cos_w"], d["sin_w"], d["amp"] * d["state_re"],
                          d["amp"] * d["state_im"])

    def iterate(self) -> None:
        # Mode params are device-resident across iterations (Metal
        # unified-memory parity); the measured round trip is dispatch +
        # output readback, like the Metal iteration (memset + dispatch +
        # read).
        out, _, _ = self._run()
        self.host_output = dev.from_device(out)

    def device_iterate(self) -> None:
        out, _, _ = self._run()
        dev.block(out)

    def stream_body(self):
        # Streaming synthesis carries the ROTATED amp-prefolded phasor
        # states across blocks. The rotation tables ride in the carry
        # (returned unchanged, so XLA aliases them): a closure capture
        # would serialize 8 bytes per mode into the compiled module.
        from gpuaudiobench_jax.harness.streaming import probe

        d = self._dev
        step_block = self._step

        def step(carry):
            cos_w, sin_w, re, im = carry
            out, re2, im2 = step_block(cos_w, sin_w, re, im)
            return (cos_w, sin_w, re2, im2), probe(out)

        re0, im0 = d["amp"] * d["state_re"], d["amp"] * d["state_im"]
        if self.cfg.modal_renorm:
            step = _renorm_wrap(step, re0, im0)
        return step, (d["cos_w"], d["sin_w"], re0, im0)

    def validate(self) -> ValidationData:
        if self.golden is None:  # verification == "none" (no golden)
            return compare_rel(
                self.host_output, self.host_output, self.tolerance,
                mode="none", label=self.name,
            )
        # Relative-to-peak metric (error <= tol * max|golden|): summing
        # thousands of f32 mode contributions carries ~1e-5-relative-to-
        # peak rounding regardless of implementation; at samples where
        # the bank destructively cancels, a per-sample relative check is
        # unbounded for ANY f32 accumulator (the Metal reference's
        # atomic-add path has the same floor and does not gate on it).
        floor = float(np.abs(self.golden).max())
        return compare_rel(
            self.host_output, self.golden, self.tolerance,
            mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
            label=self.name, floor=floor,
        )

    def cost_model(self):
        m, s = self.padded_modes, self.buffer_size
        return {
            "flops": 8 * m * s,  # 6 rotate + 2 accumulate
            "hbm_bytes": (4 * m + 2 * m + s * self.output_tracks) * 4,
            "unit": "fp32",
        }

    def total_elements(self) -> int:
        return self.buffer_size * self.output_tracks

    def bytes_processed(self) -> int:
        # mode params in + output out (Metal buffer sizes)
        return self.num_modes * NUM_MODE_PARAMS * 4 + self.total_elements() * 4

    def metadata(self):
        md = {
            "numModes": self.num_modes,
            "outputTracks": self.output_tracks,
            "numModeParams": NUM_MODE_PARAMS,
            "kernel": self._kernel,
        }
        return md

