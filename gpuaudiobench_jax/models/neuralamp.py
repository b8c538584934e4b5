"""NeuralAmp / NeuralAmpLSTM: streaming neural amp-model inference --
extension benchmarks, the suite's neural (matrix-unit) workload family.

No reference counterpart: every registered reference workload
(cuda/main.cu:84-100) is classic DSP whose arithmetic is elementwise or
a recurrence; the production audio workload that exercises the tensor
cores is neural amp/effect modeling. The two deployed architectures measure opposite
compute regimes, which is exactly the A/B accelerator deployments face:

* NeuralAmp (arch "tcn"): depth-L dilated causal TCN formulated as
  (T*S, C) x (C, C) GEMMs in a straight-line feed-forward program
  (ops/neuralamp.py tcn_block) -- big batched matrix products,
  activation traffic as the bf16 wall.
* NeuralAmpLSTM (arch "lstm"): one recurrent layer + dense out + input
  skip (the GuitarML / NeuralPi topology) -- a lax.scan with ONE small
  (T, H+1) x (H+1, 4H) GEMM per audio sample: issue/latency-bound
  sequential dispatch the matrix units cannot pipeline across samples.

Both carry their state on device across iterations exactly like the
IIR state (cuda/bench_iir.cu:19-43 semantics): the TCN its per-layer
receptive-field tails, the LSTM its (h, c) pair.

Validation replays the SAME input block through a float64 NumPy twin,
clamped at a PROVEN steady block count: the TCN's repeated-block
output is exactly periodic once its finite context fills
(ops/neuralamp.py steady_blocks, property-tested); the LSTM's orbit
converges below f64 noise after LSTM_STEADY_SAMPLES of measured
gate-contraction decay (lstm_steady_blocks, test-pinned). Tolerances
are per arch and compute dtype (errors measured on an H100 80GB HBM3
at 400 W at the default shapes are in PERF.md):

* tcn/f32 (Precision.HIGHEST, so no TF32): 1e-4 rel-to-peak.
* tcn/bf16 (fully bf16-resident: activations + tails stored bf16,
  f32 accumulation): 2e-2 -- the NN-inference contract, NOT the
  suite's 1e-3 DSP contract (bf16 eps 3.9e-3).
* lstm/f32 (Precision.HIGHEST): 1e-4.
* lstm/bf16: 1e-3 -- the gate contraction damps bf16 noise instead of
  accumulating it, where the TCN's additive residuals grow it.
"""

from __future__ import annotations

import numpy as np

from gpuaudiobench_jax.config import BenchConfig
from gpuaudiobench_jax.harness.validation import ValidationData, compare_rel
from gpuaudiobench_jax.models.common import StandardBufferBenchmark
from gpuaudiobench_jax.ops import neuralamp as na
from gpuaudiobench_jax.utils import device as dev

TOLERANCE = {
    ("tcn", "f32"): 1e-4,
    ("tcn", "bf16"): 2e-2,
    # Dynamic per-tensor activation + per-output-channel weight int8:
    # the post-training-quantization envelope, wider than bf16's.
    ("tcn", "int8"): 5e-2,
    ("lstm", "f32"): 1e-4,
    ("lstm", "bf16"): 1e-3,
}


class NeuralAmpBenchmark(StandardBufferBenchmark):
    name = "NeuralAmp"

    def __init__(self, cfg: BenchConfig, arch: str = "tcn"):
        super().__init__(cfg)
        self.arch = arch
        self.name = "NeuralAmp" if arch == "tcn" else "NeuralAmpLSTM"

    def setup(self) -> None:
        cfg = self.cfg
        self.channels = cfg.neuralamp_channels
        self.layers = cfg.neuralamp_layers
        self.dtype = cfg.neuralamp_dtype
        if (self.arch, self.dtype) not in TOLERANCE:
            raise ValueError(
                f"{self.name} does not support --neuralampDtype "
                f"{self.dtype} (int8 is TCN-only: the LSTM's per-sample "
                "GEMMs are issue-bound, not compute-bound, so the "
                "integer path has nothing to win)")
        self.tolerance = TOLERANCE[(self.arch, self.dtype)]
        self.setup_standard_buffers()

        if self.arch == "tcn":
            self.params_np = na.init_params(
                cfg.seed, self.channels, self.layers)
            cast = na.cast_params(self.params_np, self.dtype)
            state_np = na.init_tails(
                self.track_count, self.channels, self.layers, self.dtype)
            self._state = tuple(self._put_tail(t) for t in state_np)
            self.track_alloc("weights", na.param_bytes(
                self.channels, self.layers, self.dtype))
        else:
            self.params_np = na.init_lstm_params(cfg.seed, self.channels)
            cast = na.cast_lstm_params(self.params_np, self.dtype)
            state_np = (np.zeros((self.track_count, self.channels),
                                 np.float32),) * 2
            self._state = tuple(
                self.put_sharded(s) for s in state_np)  # (h, c): dp axis 0
            self.track_alloc("weights", na.lstm_param_bytes(
                self.channels, self.dtype))
        self._params = {k: self.put_replicated(v) for k, v in cast.items()}
        # Frozen state for the device-timing / streaming passes (those
        # must not consume the measured stream's carried state).
        self._timing_state = self._state
        self._invocations = 0
        self.track_alloc("state", sum(int(s.nbytes) for s in state_np))
        self.iterate()

    def _put_tail(self, t: np.ndarray):
        return (self.put_spec(t, "dp", None, None)
                if self._sharding is not None else dev.to_device(t))

    def _block(self, x, state, params):
        if self.arch == "tcn":
            y, tails = na.tcn_block(
                x, state, params, layers=self.layers, dtype=self.dtype)
            return y, tails
        y, h, c = na.lstm_block(
            x, state[0], state[1], params, dtype=self.dtype)
        return y, (h, c)

    def iterate(self) -> None:
        x = self.put_input(self.host_input)
        y, self._state = self._block(x, self._state, self._params)
        self.host_output = dev.from_device(y)
        self._invocations += 1

    def device_iterate(self) -> None:
        y, _ = self._block(
            self._resident_input, self._timing_state, self._params)
        dev.block(y)

    def overlap_body(self):
        block, params = self._block, self._params

        def f(x, state):
            y, s2 = block(x, state, params)
            return y, s2

        return f, self.overlap_blocks(), self._state

    # Weights above this ride the streaming carry instead of the
    # closure: closure-captured arrays serialize into the compiled
    # module (TCN C=512 is ~31.5 MB, and the module-size budget
    # tests/test_streaming.py enforces is 2 MB). BELOW it they stay
    # closure constants on purpose -- params-in-carry demotes the
    # weights from compile-time constants to runtime operands, which
    # can slow NeuralAmpLSTM's latency-bound per-sample scan. The
    # default LSTM (H=128, ~0.5 MB) embeds; H=512 (~4 MB) and every TCN
    # width (>=2 MB) ride the carry.
    _STREAM_CONST_BYTES = 1024 * 1024

    def stream_body(self):
        from gpuaudiobench_jax.harness.streaming import probe

        block = self._block
        params_bytes = sum(int(v.nbytes) for v in self._params.values())

        if params_bytes <= self._STREAM_CONST_BYTES:
            # Params as closure constants (the measured fast form for
            # the latency-bound LSTM scan) -- but the INPUT block still
            # rides the carry: it scales with n_tracks x buffer and is
            # not bounded by the params check, so capturing it would
            # re-inflate the serialized module at large track counts
            # (what this gate exists to prevent).
            params = self._params

            def step(carry):
                x, state = carry
                y, state2 = block(x, state, params)
                return (x, state2), probe(y)

            return step, (self._resident_input, self._timing_state)

        # Large nets: input + weights ride the carry (returned
        # unchanged, so XLA aliases them).
        def step(carry):
            x, params, state = carry
            y, state2 = block(x, state, params)
            return (x, params, state2), probe(y)

        return step, (self._resident_input, self._params,
                      self._timing_state)

    def cost_model(self):
        t, s, c = self.track_count, self.buffer_size, self.channels
        # Activation storage bytes: int8 mode stores activations/tails
        # in bf16 like the bf16 mode (quantization is per GEMM operand,
        # not storage), so its traffic floor matches bf16's.
        per = 2 if self.dtype in ("bf16", "int8") else 4
        unit = {"f32": "fp32", "bf16": "bf16",
                "int8": "int8"}[self.dtype]
        if self.arch == "lstm":
            return {
                # One (T, H+1) x (H+1, 4H) gate GEMM + the dense out
                # per sample; gate nonlinearities are O(H) beside them.
                "flops": int(t * s * (2 * (c + 1) * 4 * c + 2 * c)),
                # Weights stay on chip across the scan; the block's
                # device-memory story is just x/y and the (h, c) state
                # -- the workload is issue-bound, not traffic-bound.
                "hbm_bytes": int(
                    2 * t * s * 4 + 4 * t * c * 4
                    + na.lstm_param_bytes(c, self.dtype)),
                "unit": unit,
            }
        l, k = self.layers, na.KERNEL
        act = t * s * c * per  # one (T, S, C) activation
        tail_bytes = 2 * sum(
            t * ctx * c * per for ctx in na.context_lengths(l))
        return {
            # GEMM MACs only (the in/out 1x1 convs and tanh are O(C)
            # per sample against the layers' O(K*C^2)).
            "flops": int(t * s * (2 * c + 2 * k * c * c * l + 2 * c)),
            # Activations exceed on-chip memory at the default shape
            # (T*S*C f32 = 32 MiB), so each layer's input is read from
            # and output written to device memory once even with
            # perfect fusion; plus the
            # carried tails (read+write), the weights, and the x/y
            # blocks.
            "hbm_bytes": int(
                (2 * l + 2) * act + tail_bytes
                + na.param_bytes(self.channels, l, self.dtype)
                + 2 * t * s * 4),
            "unit": unit,
        }

    def validate(self) -> ValidationData:
        if self.cfg.verification == "none":
            return compare_rel(
                self.host_output, self.host_output, self.tolerance,
                mode="none", label=self.name)
        if self.arch == "tcn":
            golden = na.tcn_reference(
                self.host_input, self._invocations, self.params_np,
                self.layers)
        else:
            golden = na.lstm_reference(
                self.host_input, self._invocations, self.params_np)
        self.golden = golden
        floor = float(np.abs(golden).max())
        return compare_rel(
            self.host_output, golden, self.tolerance,
            mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
            label=self.name, floor=floor)

    def metadata(self):
        md = {
            "arch": self.arch,
            "channels": self.channels,
            "dtype": self.dtype,
        }
        if self.arch == "tcn":
            md.update({
                "layers": self.layers,
                "receptiveField": na.receptive_field(self.layers),
                "steadyBlocks": na.steady_blocks(
                    self.layers, self.buffer_size),
                "paramBytes": na.param_bytes(
                    self.channels, self.layers, self.dtype),
            })
        else:
            md.update({
                "steadyBlocks": na.lstm_steady_blocks(self.buffer_size),
                "paramBytes": na.lstm_param_bytes(
                    self.channels, self.dtype),
            })
        return md
