"""PartConv: uniformly-partitioned overlap-save streaming convolution
(convolution reverb) -- extension benchmark.

No reference counterpart: Conv1D_accel (cuda/bench_conv1d_accel.cu)
fast-convolves one buffer against a single-segment IR; this benchmark
streams a long (default 1 s = 48000-tap) IR through a frequency-domain
delay line, the technique production convolution reverbs use. The FDL
and the previous input block persist on-device across iterations
exactly like the IIR state (bench_iir.cu:19-43 semantics) and the
modal phasors, making this the framework's long-memory streaming
workload: P = ceil(irLength/bufferSize) blocks of history are live at
all times.

Validation is a closed-form fold-algebra golden, not a replay of the
device algorithm: with the same block x fed every iteration, output
block k of the stream equals

    circular(x, sum of IR partitions 0..k-2)  +  head(x, partition k-1)

where "circular" is the B-periodic convolution (computed in float64)
and "head" is the first B samples of the linear convolution with
partition k-1 (absent once k > P). The golden is therefore exact
streaming semantics in f64 time-domain algebra, structurally
independent of the device's partitioned-FFT path. Relative-to-peak
tolerance 1e-3 (the Conv1D_accel FFT class,
bench_conv1d_accel.cu:310).
"""

from __future__ import annotations

import math

import jax
import numpy as np

from gpuaudiobench_jax.harness.validation import ValidationData, compare_rel
from gpuaudiobench_jax.models.common import StandardBufferBenchmark
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
from gpuaudiobench_jax.utils import device as dev
from gpuaudiobench_jax.utils.data import reverb_impulse_responses

DEFAULT_IR_LENGTH = 48000  # 1.0 s at the default 48 kHz


def partconv_reference(
    x: np.ndarray, ir: np.ndarray, k: int, block_size: int
) -> np.ndarray:
    """Float64 output block k (1-indexed) of streaming convolution of
    the k-times-repeated block x with ir (see module docstring)."""
    t, b = x.shape
    length = ir.shape[1]
    p = num_partitions(length, b)
    parts = np.zeros((t, p * b), np.float64)
    parts[:, :length] = ir.astype(np.float64)
    parts = parts.reshape(t, p, b)
    x64 = x.astype(np.float64)

    n_folded = min(k - 1, p)
    fold = parts[:, :n_folded].sum(axis=1) if n_folded else np.zeros(
        (t, b), np.float64)
    # Circular (B-periodic) convolution via f64 FFT.
    y = np.fft.irfft(np.fft.rfft(x64, axis=1) * np.fft.rfft(fold, axis=1),
                     b, axis=1)
    if k <= p:
        # Head of the linear convolution with partition k-1, batched
        # over tracks via a zero-padded f64 FFT (a per-track
        # np.convolve loop is O(T*B^2) -- minutes at capacity-probe
        # track counts; f64 FFT rounding ~1e-13 is far inside the
        # 1e-3 golden tolerance).
        tail = parts[:, k - 1]
        y += np.fft.irfft(
            np.fft.rfft(x64, 2 * b, axis=1)
            * np.fft.rfft(tail, 2 * b, axis=1), 2 * b, axis=1)[:, :b]
    return y.astype(np.float32)


class PartConvBenchmark(StandardBufferBenchmark):
    name = "PartConv"
    tolerance = 1e-3  # relative-to-peak, the FFT-convolution class

    def setup(self) -> None:
        self.ir_length = self.cfg.ir_length or DEFAULT_IR_LENGTH
        self.partitions = num_partitions(self.ir_length, self.buffer_size)
        self.setup_standard_buffers()
        self.ir = reverb_impulse_responses(
            self.track_count, self.ir_length, self.cfg.seed)

        form = self.cfg.partconv_form
        self.nupols_tail = 0
        if form == "nupols":
            self.nupols_tail = nupols_tail_partitions(
                self.ir_length, self.buffer_size,
                self.cfg.partconv_tail_chunk)
            if self.nupols_tail == 0:
                # The K-slot head covers the whole IR: nupols
                # degenerates to (a padded) uniform head; run the
                # cheaper exact-P shift form and say so in metadata.
                form = "shift"
        self._form = form

        t = self.track_count
        b = self.buffer_size
        zeros_prev = np.zeros((t, b), np.float32)
        if form == "nupols":
            k = self.cfg.partconv_tail_chunk
            m = self.nupols_tail
            (hh_re, hh_im), (ht_re, ht_im) = nupols_spectra(
                dev.to_device(self.ir), b, k)
            h_np = tuple(np.asarray(a)
                         for a in (hh_re, hh_im, ht_re, ht_im))
            if self.cfg.partconv_h_dtype == "f16":
                h_np = tuple(h.astype(np.float16) for h in h_np)
            self._h = tuple(self._put_state(h) for h in h_np)
            block = make_partconv_block_nupols(b, k, m)
            self._block = lambda x, state, h: block(x, state, *h)
            state_np = nupols_init_state(t, b, k, m)
            # The 0-dim leaves (blk, the ring head) stay host scalars: an
            # uncommitted operand is replicated under dp sharding,
            # where a device_put would pin it to one device and
            # conflict with the sharded leaves (the shift form's head
            # scalar works the same way).
            self._state = jax.tree_util.tree_map(
                lambda a: self._put_state(a) if a.ndim else a, state_np)
            # Head FDL planes + the DOUBLED tail ring (2M slots per
            # plane), from the allocated leaves so metadata can never
            # drift from the real footprint again.
            fdl_bytes = (state_np[1].nbytes + state_np[2].nbytes
                         + state_np[9].nbytes + state_np[10].nbytes)
        else:
            h_re, h_im = partition_spectra(
                dev.to_device(self.ir), self.buffer_size)
            if form == "ring":
                # Doubled index-negated planes: the per-block ring
                # alignment becomes one contiguous dynamic_slice
                # window (ops/partconv.py ring_aligned_spectra). 2x H
                # storage for stream-rate reads.
                h_re, h_im = ring_aligned_spectra(h_re, h_im)
            h_np = (np.asarray(h_re), np.asarray(h_im))
            if self.cfg.partconv_h_dtype == "f16":
                # Measured 1.9e-4 peak-relative vs the 1e-3 contract
                # at the default shape; halves the H read
                # (docs/BENCHMARKS.md).
                h_np = tuple(h.astype(np.float16) for h in h_np)
            self._h = tuple(self._put_state(h) for h in h_np)
            bins = b + 1
            zeros_fdl = np.zeros((t, self.partitions, bins), np.float32)
            fdl = self._put_state(zeros_fdl)
            fdl_im = self._put_state(zeros_fdl)
            prev = self._put_state(zeros_prev)
            # Ring head (ops/partconv.py partconv_block_ring): the FDL
            # never shifts; the first block writes slot 0. The shift
            # form (the default) carries the head untouched.
            head = np.int32(self.partitions - 1)
            if form == "ring":
                def _ring(x, state, h):
                    prev, head, fre, fim = state
                    y, head2, fre2, fim2 = partconv_block_ring(
                        x, prev, head, fre, fim, *h)
                    return y, (x, head2, fre2, fim2)
                self._block = _ring
            else:
                def _shift(x, state, h):
                    prev, head, fre, fim = state
                    y, fre2, fim2 = partconv_block(
                        x, prev, fre, fim, *h)
                    return y, (x, head, fre2, fim2)
                self._block = _shift
            self._state = (prev, head, fdl, fdl_im)
            fdl_bytes = 2 * zeros_fdl.nbytes
        # Frozen state copy for the device-timing / streaming passes.
        self._timing_state = self._state
        self._invocations = 0
        self.track_alloc("irSpectra", sum(h.nbytes for h in h_np))
        self._fdl_bytes = fdl_bytes
        self.track_alloc("fdl", fdl_bytes)
        self.iterate()

    def _put_state(self, a: np.ndarray):
        return (self.put_spec(a, "dp") if self._sharding is not None
                else dev.to_device(a))

    def iterate(self) -> None:
        x = self.put_input(self.host_input)
        y, self._state = self._block(x, self._state, self._h)
        self.host_output = dev.from_device(y)
        self._invocations += 1

    def device_iterate(self) -> None:
        y, _ = self._block(
            self._resident_input, self._timing_state, self._h)
        dev.block(y)

    def overlap_body(self):
        block, h = self._block, self._h

        def f(x, state):
            y, s2 = block(x, state, h)
            return y, s2

        return f, self.overlap_blocks(), self._state

    def stream_body(self):
        from gpuaudiobench_jax.harness.streaming import probe

        x, block = self._resident_input, self._block

        # The IR spectra and the (T, S) input block ride in the carry
        # (returned unchanged, so XLA aliases them): a closure capture
        # would serialize ~8 bytes per (track, partition, bin) -- plus
        # T x S x 4 input bytes -- into the compiled module, hundreds
        # of MB at the track counts soaks and capacity probes reach.
        def step(carry):
            xc, state, h = carry
            y, state2 = block(xc, state, h)
            return (xc, state2, h), probe(y)

        return step, (x, self._timing_state, self._h)

    def cost_model(self):
        t, b = self.track_count, self.buffer_size
        p, bins = self.partitions, b + 1
        if not hasattr(self, "_form"):  # pre-setup (tests poke shapes)
            self._form = self.cfg.partconv_form
        n = 2 * b
        fft_flops = 2.5 * n * math.log2(n)  # real-FFT flop model
        hdt = 2 if self.cfg.partconv_h_dtype == "f16" else 4
        if self._form == "nupols":
            k = self.cfg.partconv_tail_chunk
            m = self.nupols_tail
            kbins = k * b + 1
            nk = 2 * k * b
            fft_k = 2.5 * nk * math.log2(nk)
            return {
                # Head = K-slot uniform shift; tail FFTs + MAC + FDL
                # push amortized over the K-block window; the spread
                # accumulator adds per block.
                "flops": int(t * (2 * fft_flops + 8 * k * bins
                                  + (2 * fft_k + 8 * m * kbins) / k
                                  + 2 * kbins)),
                # Head FDL r+w + H read; tail per fire (/K): MAC FDL
                # read (8 B/bin) + H read (2*hdt); every block: the
                # idempotent ring write (2 slots x 2 planes = 16 B/bin,
                # M-independent) + acc r+w (16 B/bin).
                "hbm_bytes": int(
                    t * (4 * k * bins * 4 + 2 * k * bins * hdt
                         + (8 + 2 * hdt) * m * kbins / k
                         + 32 * kbins + 2 * b * 4)),
                "unit": "fp32",
            }
        return {
            # forward + inverse FFT, plus the 8-flop complex MAC per
            # (partition, bin).
            "flops": int(t * (2 * fft_flops + 8 * p * bins)),
            # Ring form: one FDL read + one contiguous H2-window read
            # (P slots of the doubled spectra) per block, two planes
            # each (FDL f32; H f32 or f16); the one-slot write and the
            # x/y block traffic ride along. The shift form adds a full
            # FDL rewrite.
            "hbm_bytes": (
                (2 if self._form == "ring" else 4)
                * t * p * bins * 4         # FDL read (+rewrite if shift)
                + 2 * t * p * bins * hdt   # H
                + 2 * t * b * 4),
            "unit": "fp32",
        }

    def validate(self) -> ValidationData:
        if self.cfg.verification == "none":  # skip the golden entirely
            return compare_rel(
                self.host_output, self.host_output, self.tolerance,
                mode="none", label=self.name,
            )
        golden = partconv_reference(
            self.host_input, self.ir, self._invocations, self.buffer_size)
        self.golden = golden
        floor = float(np.abs(golden).max())
        return compare_rel(
            self.host_output, golden, self.tolerance,
            mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
            label=self.name, floor=floor,
        )

    def metadata(self):
        md = {
            "irLength": self.ir_length,
            "form": self.cfg.partconv_form,
            "formResolved": self._form,  # nupols falls back to shift
            #                              when the head covers the IR
            "hDtype": self.cfg.partconv_h_dtype,
            "partitions": self.partitions,
            "fftSize": 2 * self.buffer_size,
            # The allocated footprint (setup's track_alloc source),
            # incl. the nupols tail ring's DOUBLED (2M-slot) planes.
            "fdlBytes": self._fdl_bytes,
        }
        if self._form == "nupols":
            k = self.cfg.partconv_tail_chunk
            md.update({
                "nupolsTailChunk": k,
                "nupolsHeadPartitions": k,
                "nupolsTailPartitions": self.nupols_tail,
                "nupolsTailFftSize": 2 * k * self.buffer_size,
            })
        return md
