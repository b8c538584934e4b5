"""DAWSessionMix: a full mixing-session graph as ONE streamed block --
extension benchmark (the framework's composite production workload).

No single reference counterpart: this composes the reference's own
channel-strip pieces the way a DAW session wires them --

  * per-track EQ: a K-stage biquad cascade (the serial-chain workload
    of metal-swift/.../Metal/kernels_extra.metal:16-67 at the IIR
    recurrence semantics of cuda/bench_iir.cu:10-44),
  * a post-fader reverb send bus: the tracks' EQ outputs, scaled by
    per-track send levels, summed to one bus signal that feeds a
    stereo partitioned-convolution reverb (the production long-IR
    streaming scheme; see models/partconv.py -- the cuFFT fast-conv
    idea of cuda/bench_conv1d_accel.cu:9-47 made streaming),
  * constant-power pan + channel gain into a stereo mix bus, wet
    return added.

Where every other benchmark isolates one kernel class, this one
measures what the suite exists to predict: the cost of a realistic
SESSION -- recurrence + reduction + spectral streaming in one jitted
program, all state (EQ biquad z's, the reverb's previous bus block +
frequency-domain delay line) carried on-device across blocks exactly
like the reference's persistent d_state (bench_iir.cu:19-43).

Structure: the EQ cascade is a scan over samples with all tracks in
lockstep (ops/iir.py); the bus sum is a reduction over tracks (under
--dataParallel it becomes the psum across the dp mesh -- the one
cross-device collective in the graph); the reverb runs on the 2-track (L/R) bus at FFT size 2B, so
its cost is track-count-independent; the mixdown is a (2, T) x (T, B)
matmul. One block = one executable, no host round-trips inside.

Validation: full-replay golden. The EQ transient settles in well
under ``_EQ_SETTLE_SAMPLES`` samples (Butterworth pole radii <= 0.72
at the narrowest staggered cutoff), after which the repeated-block
stream is periodic except for the reverb's P-block memory, so the
replay is clamped at P + settle + margin blocks; a test pins the
clamped golden against the unclamped one. EQ replays in float32
(op-order-identical iir_reference, models/iir.py:25); the bus and the
reverb replay in float64 via one exact linear convolution of the
whole bus history (the same independence-from-the-device-algorithm
discipline as models/partconv.py's fold-algebra golden). Tolerance is
relative-to-peak 1e-3, the FFT-convolution contract class
(cuda/bench_conv1d_accel.cu:310) that dominates the graph's error.
"""

from __future__ import annotations

import math

import numpy as np

from gpuaudiobench_jax.harness.validation import ValidationData, compare_rel
from gpuaudiobench_jax.models.common import StandardBufferBenchmark
from gpuaudiobench_jax.models.iir import iir_reference
from gpuaudiobench_jax.ops.partconv import (
    num_partitions,
    partconv_block,
    partition_spectra,
)
from gpuaudiobench_jax.utils import device as dev
from gpuaudiobench_jax.utils.data import (
    biquad_lowpass_coefficients,
    reverb_impulse_responses,
)

DEFAULT_IR_LENGTH = 48000  # 1.0 s reverb tail at the default 48 kHz
WET_GAIN = 0.3  # reverb return level into the mix bus
# Upper bound on the EQ cascade's transient, in samples: the narrowest
# staggered cutoff (0.25 - 0.0125*15 = 0.0625) has Butterworth pole
# radius ~0.72, whose transient is below f32 resolution (1e-8 of
# initial) within ~60 samples; 1024 is a wide safety factor that stays
# cheap at any buffer size.
_EQ_SETTLE_SAMPLES = 1024


def session_mix_params(track_count: int, seed: int):
    """Deterministic per-track console settings: (send (T,), pan2 (2, T)).

    send = post-fader reverb send levels, scaled 1/sqrt(T) so the bus
    level (a sum of T near-independent tracks) is track-count-invariant
    across capacity probes; pan2 = channel gain folded into
    constant-power pan weights (the standard -3 dB-center pan law).
    Seeded apart from the audio/IR generators (seed ^ 0x5E55) so the
    console is not correlated with the program material.
    """
    g = np.random.default_rng(seed ^ 0x5E55)
    gain = 0.5 + 0.5 * g.random(track_count)
    theta = g.random(track_count) * (np.pi / 2.0)
    send = (0.05 + 0.25 * g.random(track_count)) / math.sqrt(track_count)
    pan2 = np.stack([gain * np.cos(theta), gain * np.sin(theta)])
    return send.astype(np.float32), pan2.astype(np.float32)


def session_reference(
    x: np.ndarray,
    stage_coeffs,
    send: np.ndarray,
    pan2: np.ndarray,
    ir: np.ndarray,
    wet: float,
    k: int,
    clamp: int | None = None,
) -> np.ndarray:
    """(2, B) golden mix at block ``k`` (1-indexed) of the stream that
    feeds the same block ``x`` every iteration.

    Full replay: the float32 EQ cascade state evolves block by block
    exactly as the device's does; the reverb is ONE float64 linear
    convolution of the accumulated bus history with the stereo IR,
    sliced at block k -- exact streaming-convolution semantics with no
    partitioned-FFT structure shared with the device path. ``clamp``
    bounds the replay length (see module docstring); tests pin the
    clamped result against the unclamped one.
    """
    t, b = x.shape
    if clamp is not None:
        k = min(k, clamp)
    n_stages = len(stage_coeffs)
    eq_state = [np.zeros((t, 2), np.float32) for _ in range(n_stages)]
    bus_hist = np.zeros((k, b), np.float64)
    send64 = send.astype(np.float64)
    y = x
    for blk in range(k):
        y = x
        for s in range(n_stages):
            y, eq_state[s] = iir_reference(y, stage_coeffs[s], eq_state[s])
        bus_hist[blk] = send64 @ y.astype(np.float64)
    length = ir.shape[1]
    nfft = k * b + length
    spec = np.fft.rfft(bus_hist.ravel(), nfft)
    rev = np.fft.irfft(
        spec[None, :] * np.fft.rfft(ir.astype(np.float64), nfft, axis=1),
        nfft, axis=1,
    )[:, (k - 1) * b : k * b]
    dry = pan2.astype(np.float64) @ y.astype(np.float64)
    return (dry + wet * rev).astype(np.float32)


def make_session_core():
    """One session block: (mix (2, B), eq', bus_block, fdl_re', fdl_im')."""
    import jax
    import jax.numpy as jnp

    from gpuaudiobench_jax.ops.iir import iir_cascade_xla

    def core(x, coeffs, eq_states, send, pan2, prev, fre, fim, h_re, h_im):
        y, eq2 = iir_cascade_xla(x, coeffs, eq_states)
        # Post-fader send sum -> the one cross-track (psum under dp)
        # reduction in the graph; the stereo bus feeds L/R IRs. Both
        # contractions are tiny; a default-precision f32 dot may run in
        # reduced precision (TF32 on the GPU, ~1e-3 relative, the size
        # of the tolerance), so HIGHEST keeps them f32 at negligible
        # cost.
        hi = jax.lax.Precision.HIGHEST
        bus = jnp.einsum("t,tb->b", send, y, precision=hi)
        xbus = jnp.stack([bus, bus])
        rev, fre2, fim2 = partconv_block(xbus, prev, fre, fim, h_re, h_im)
        mix = (jnp.einsum("ct,tb->cb", pan2, y, precision=hi)
               + jnp.float32(WET_GAIN) * rev)
        return mix, eq2, xbus, fre2, fim2

    return core


class DAWSessionMixBenchmark(StandardBufferBenchmark):
    name = "DAWSessionMix"
    tolerance = 1e-3  # relative-to-peak, the FFT-convolution class

    def setup(self) -> None:
        import jax

        cfg = self.cfg
        self.eq_stages = cfg.session_eq_stages
        self.ir_length = cfg.ir_length or DEFAULT_IR_LENGTH
        self.partitions = num_partitions(self.ir_length, self.buffer_size)
        self.setup_standard_buffers()

        # Console: staggered-cutoff EQ cascade + deterministic sends/pans.
        self.stage_coeffs = [
            biquad_lowpass_coefficients(0.25 - 0.0125 * k)
            for k in range(self.eq_stages)
        ]
        coeffs_arr = np.array(self.stage_coeffs, np.float32)
        self._coeffs_dev = self.put_replicated(coeffs_arr)
        self.send_np, self.pan2_np = session_mix_params(
            self.track_count, cfg.seed)
        self._send = self.put_spec(self.send_np, "dp") \
            if self._sharding is not None else dev.to_device(self.send_np)
        self._pan2 = self.put_spec(self.pan2_np, None, "dp") \
            if self._sharding is not None else dev.to_device(self.pan2_np)

        # Stereo reverb bus: 2-track partitioned convolution state.
        self.ir = reverb_impulse_responses(2, self.ir_length, cfg.seed)
        h_re, h_im = partition_spectra(
            dev.to_device(self.ir), self.buffer_size)
        h_np = (np.asarray(h_re), np.asarray(h_im))
        self._h = tuple(self.put_replicated(h) for h in h_np)

        t, b = self.track_count, self.buffer_size
        zero_eq = np.zeros((self.eq_stages, t, 2), np.float32)
        self._eq = self.put_spec(zero_eq, None, "dp") \
            if self._sharding is not None else dev.to_device(zero_eq)
        zero_fdl = np.zeros((2, self.partitions, b + 1), np.float32)
        self._prev = self.put_replicated(np.zeros((2, b), np.float32))
        self._fre = self.put_replicated(zero_fdl)
        self._fim = self.put_replicated(zero_fdl)
        # Frozen zero-state handles for device-timing / streaming passes.
        self._timing = (self._eq, self._prev, self._fre, self._fim)

        self._step = jax.jit(make_session_core())
        self._invocations = 0

        self.track_alloc("irSpectra", sum(h.nbytes for h in h_np))
        self.track_alloc("fdl", 2 * zero_fdl.nbytes)
        self.track_alloc("eqState", zero_eq.nbytes)
        self.iterate()

    def iterate(self) -> None:
        x = self.put_input(self.host_input)
        mix, self._eq, self._prev, self._fre, self._fim = self._step(
            x, self._coeffs_dev, self._eq, self._send, self._pan2,
            self._prev, self._fre, self._fim, *self._h)
        self.host_output = dev.from_device(mix)
        self._invocations += 1

    def overlap_body(self):
        step = self._step
        coeffs, send, pan2, h = (self._coeffs_dev, self._send,
                                 self._pan2, self._h)

        def f(x, carry):
            eq, prev, fre, fim = carry
            mix, eq, prev, fre, fim = step(
                x, coeffs, eq, send, pan2, prev, fre, fim, *h)
            return mix, (eq, prev, fre, fim)

        return (f, self.overlap_blocks(),
                (self._eq, self._prev, self._fre, self._fim))

    def device_iterate(self) -> None:
        eq, prev, fre, fim = self._timing
        mix, *_ = self._step(
            self._resident_input, self._coeffs_dev, eq, self._send,
            self._pan2, prev, fre, fim, *self._h)
        dev.block(mix)

    def stream_body(self):
        from gpuaudiobench_jax.harness.streaming import probe

        step_fn = self._step
        x, coeffs = self._resident_input, self._coeffs_dev
        send, pan2 = self._send, self._pan2

        # The IR spectra AND every track-scaled operand (the (T, S)
        # input block, send levels, pan matrix) ride in the carry
        # (returned unchanged, so XLA aliases them) rather than closing
        # over them -- the PartConv lesson: closure-captured arrays
        # serialize into the module (the input alone is 128 MB at
        # 65536 strips). Only the 5-float EQ
        # coeff rows stay closure constants.
        def step(carry):
            x, send_c, pan_c, eq, prev, fre, fim, h = carry
            mix, eq2, xbus, fre2, fim2 = step_fn(
                x, coeffs, eq, send_c, pan_c, prev, fre, fim, *h)
            return (x, send_c, pan_c, eq2, xbus, fre2, fim2, h), probe(mix)

        eq, prev, fre, fim = self._timing
        return step, (x, send, pan2, eq, prev, fre, fim, self._h)

    def _replay_clamp(self) -> int:
        settle_blocks = -(-_EQ_SETTLE_SAMPLES // self.buffer_size)
        return self.partitions + settle_blocks + 8

    def validate(self) -> ValidationData:
        if self.cfg.verification == "none":  # skip the replay entirely
            return compare_rel(
                self.host_output, self.host_output, self.tolerance,
                mode="none", label=self.name,
            )
        golden = session_reference(
            self.host_input, self.stage_coeffs, self.send_np, self.pan2_np,
            self.ir, WET_GAIN, self._invocations,
            clamp=self._replay_clamp(),
        )
        self.golden = golden
        floor = float(np.abs(golden).max())
        return compare_rel(
            self.host_output, golden, self.tolerance,
            mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
            label=self.name, floor=floor,
        )

    def cost_model(self):
        t, b = self.track_count, self.buffer_size
        n = t * b
        p, bins = self.partitions, b + 1
        nfft = 2 * b
        fft_flops = 2.5 * nfft * math.log2(nfft)
        return {
            # EQ cascade (9/sample/stage) + send reduction (2/sample)
            # + stereo reverb on the 2-track bus (fwd+inv FFT + 8-flop
            # complex MAC per partition bin) + pan matmul (4/sample)
            # + wet return add.
            "flops": int(9 * self.eq_stages * n + 2 * n
                         + 2 * (2 * fft_flops + 8 * p * bins)
                         + 4 * n + 4 * b),
            # x read + mix write + EQ state r/w + shift-form FDL r+w on
            # the 2-track bus (4 passes x 2 planes) + H read (2 planes);
            # the (2, B) bus/prev blocks ride along.
            "hbm_bytes": int(
                n * 4 + 2 * b * 4
                + 2 * self.eq_stages * t * 2 * 4
                + (4 + 2) * 2 * p * bins * 4
                + 4 * 2 * b * 4),
            "unit": "fp32",
        }

    def bytes_processed(self) -> int:
        return (self.total_elements() + 2 * self.buffer_size) * 4

    def metadata(self):
        md = {
            "eqStages": self.eq_stages,
            "irLength": self.ir_length,
            "partitions": self.partitions,
            "wetGain": WET_GAIN,
            "replayClamp": self._replay_clamp(),
        }
        return md
