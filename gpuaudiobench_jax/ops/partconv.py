"""Uniformly-partitioned overlap-save (UPOLS) streaming convolution:
the real-time convolution-reverb engine, as one jitted block program.

Extension beyond the reference's registered set: Conv1D_accel
(cuda/bench_conv1d_accel.cu) fast-convolves one buffer with an IR short
enough for a single FFT segment (fftSize = nextPow2(irLen + bufSize -
1), bench_conv1d_accel.cu:52), which stops being viable once the IR is
tens of thousands of taps. Production convolution reverbs instead split
the IR into bufferSize partitions, keep a frequency-domain delay line
(FDL) of past input spectra, and per block pay one forward FFT, one
multiply-accumulate across partitions, and one inverse FFT.

Design:
* One FFT size everywhere: N = 2*B (50% overlap-save), so the hot loop
  is two batched rffts of static shape plus an elementwise complex MAC
  reduced over the partition axis -- XLA fuses the MAC with the
  surrounding FFT gathers, and there is no data-dependent shape
  anywhere.
* The FDL lives in device memory as two float32 (T, P, bins) planes
  (explicit re/im: complex64 never crosses host<->device on some PJRT
  runtimes -- the ops/conv.py precompute_ir_spectra workaround -- and
  the 4-mul complex product runs on real lanes anyway).
* The delay line DEFAULT is the textbook SHIFT form (partconv_block):
  a full sequential FDL rewrite every block -- an extra read+write
  pass over the FDL that the ring form below does not pay. Which form
  is faster on the GPU is not measured yet; `--partconvForm ring`
  selects the ring.
* Ring form: aligning H to a never-moving FDL needs a rotation by the
  traced head. A rotated partition GATHER (jnp.take with a traced
  index vector) lowers row by row, so the ring instead stores the
  spectra DOUBLED and index-negated along the partition axis
  (ring_aligned_spectra: H2[j] = H[(-j) mod P], shape (T, 2P, bins)),
  so the alignment H[(head - s) mod P], s = 0..P-1 is the CONTIGUOUS
  window H2[P-head : 2P-head] -- one dynamic_slice (2x H storage, no
  FDL rewrite). In a chained streaming scan the window read may stop
  fusing and cost a materialized copy.

The partition spectra are computed once at setup on the device (the
cuFFT-plan + precomputeImpulseResponseFFTs analog,
bench_conv1d_accel.cu:254-304).

NON-UNIFORM form (--partconvForm nupols): the Gardner (1995)
production-reverb scheme, two levels. Uniform partitioning reads the
ENTIRE FDL and H every block -- O(irLength) HBM traffic per block --
although the old spectra change only one slot per block. The nupols
form keeps the first K*B taps in a K-slot uniform head (exactly the
shift form above) and splits the tail into partitions of K*B taps
processed at chunk granularity: one rfft(2KB) per K blocks, the tail
MAC SPREAD across the K blocks of each window (a carried
partial-spectrum accumulator; each block phase reads its L-slot share
of the doubled ring FDL as one contiguous dynamic_slice), and one
irfft(2KB) per window whose KB-sample result is served B at a time.
Amortized tail traffic: each tail slot is read once per K blocks
instead of every block -- a ~K-fold cut on the tail, which dominates
for long IRs. Per-block cost is near-uniform BY CONSTRUCTION: there
is no conditional on any large array (the window FFTs run every block
and cost microseconds; only small-array state updates are gated by
select) -- see make_partconv_block_nupols for why the first design's
lax.cond was removed. Head size K*B is exactly the
causality bound: the tail's first partition sits at tap offset K*B,
so the chunk completing at block wK-1 is first needed for output
block wK -- its spectrum (the m=0 term) folds in AT the boundary
block, while every older slot (m >= 1) has a full window and is
spread. The scheme is the SAME linear filter -- the fold-algebra
golden and the shift-form oracle validate it unchanged.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def num_partitions(ir_length: int, block_size: int) -> int:
    return max(1, -(-ir_length // block_size))


@functools.partial(jax.jit, static_argnames=("block_size",))
def partition_spectra(ir: jax.Array, block_size: int):
    """(T, L) IRs -> float32 re/im spectra of shape (T, P, B+1).

    Partition p holds rfft([ir[pB:(p+1)B], zeros(B)]): the first half
    carries the taps, the second half is the overlap-save guard.
    """
    t, l = ir.shape
    b = block_size
    p = num_partitions(l, b)
    padded = jnp.zeros((t, p * b), jnp.float32).at[:, :l].set(ir)
    parts = padded.reshape(t, p, b)
    seg = jnp.concatenate([parts, jnp.zeros_like(parts)], axis=-1)
    spec = jnp.fft.rfft(seg, axis=-1)
    return (spec.real.astype(jnp.float32), spec.imag.astype(jnp.float32))


def _forward_spectrum(x, prev):
    b = x.shape[1]
    seg = jnp.concatenate([prev, x], axis=1)  # (T, 2B) overlap-save
    spec = jnp.fft.rfft(seg, axis=1)  # (T, B+1)
    return spec.real.astype(jnp.float32), spec.imag.astype(jnp.float32)


def _inverse_block(y_re, y_im, b):
    y_full = jnp.fft.irfft(jax.lax.complex(y_re, y_im), 2 * b, axis=1)
    return y_full[:, b:].astype(jnp.float32)


@jax.jit
def partconv_block(x, prev, fdl_re, fdl_im, h_re, h_im):
    """One streamed block of uniformly-partitioned overlap-save conv,
    SHIFT form: the delay line physically moves one slot per block.

    x, prev:        (T, B) current and previous input blocks
    fdl_re/fdl_im:  (T, P, B+1) delay line of past input spectra,
                    newest first
    h_re/h_im:      (T, P, B+1) partition spectra from partition_spectra

    Returns (y, fdl_re', fdl_im'): y is the (T, B) output block; the
    caller carries (x, fdl') as the next block's (prev, fdl).

    This is the DEFAULT form: the shift is two full sequential passes
    over the FDL (read + write) that the ring form does not pay, in
    exchange for contiguous reads in the chained streaming tier (module
    docstring).
    """
    b = x.shape[1]
    sre, sim = _forward_spectrum(x, prev)
    fdl_re = jnp.concatenate([sre[:, None], fdl_re[:, :-1]], axis=1)
    fdl_im = jnp.concatenate([sim[:, None], fdl_im[:, :-1]], axis=1)
    # Complex MAC over partitions: Y = sum_p FDL[p] * H[p]. H may be
    # stored narrower (f16, --partconvHDtype); compute is f32 — the
    # convert fuses into the (traffic-bound) read.
    hr = h_re.astype(jnp.float32)
    hi = h_im.astype(jnp.float32)
    y_re = jnp.sum(fdl_re * hr - fdl_im * hi, axis=1)
    y_im = jnp.sum(fdl_re * hi + fdl_im * hr, axis=1)
    return _inverse_block(y_re, y_im, b), fdl_re, fdl_im


def ring_aligned_spectra(h_re, h_im):
    """(T, P, bins) partition spectra -> (T, 2P, bins) doubled,
    index-negated planes for partconv_block_ring: H2[j] = H[(-j) mod P]
    for j = 0..2P-1, so the ring alignment H[(head - s) mod P],
    s = 0..P-1 is the contiguous window H2[P-head : 2P-head] (one
    dynamic_slice per block instead of a partition gather). Computed
    once at setup (the static gather here is free); 2x H storage.
    """
    p = h_re.shape[1]
    idx = (-jnp.arange(2 * p)) % p
    return jnp.take(h_re, idx, axis=1), jnp.take(h_im, idx, axis=1)


@jax.jit
def partconv_block_ring(x, prev, head, fdl_re, fdl_im, h2_re, h2_im):
    """Ring-buffer form (--partconvForm ring): the FDL never moves.

    The new spectrum overwrites ONE slot (head); slot s then holds the
    spectrum of the block (head - s) mod P blocks ago, so
    Y = sum_s FDL[s] * H[(head - s) mod P]. h2_re/h2_im are the
    DOUBLED index-negated spectra from ring_aligned_spectra
    ((T, 2P, bins)): the alignment is the contiguous window
    H2[P-head : 2P-head], one dynamic_slice fused into the MAC's read
    -- sequential device-memory traffic, where a jnp.take partition
    gather lowers row by row (module docstring).
    Traffic per block is one read of FDL + one window read of H2; the
    shift form additionally rewrites the whole FDL every block.

    head is an int32 scalar carried by the caller, incremented mod P
    here. Returns (y, head', fdl_re', fdl_im').
    """
    b = x.shape[1]
    p = fdl_re.shape[1]
    sre, sim = _forward_spectrum(x, prev)
    head = (head + 1) % p
    fdl_re = jax.lax.dynamic_update_slice_in_dim(
        fdl_re, sre[:, None], head, axis=1)
    fdl_im = jax.lax.dynamic_update_slice_in_dim(
        fdl_im, sim[:, None], head, axis=1)
    hr = jax.lax.dynamic_slice_in_dim(
        h2_re, p - head, p, axis=1).astype(jnp.float32)
    hi = jax.lax.dynamic_slice_in_dim(
        h2_im, p - head, p, axis=1).astype(jnp.float32)
    y_re = jnp.sum(fdl_re * hr - fdl_im * hi, axis=1)
    y_im = jnp.sum(fdl_re * hi + fdl_im * hr, axis=1)
    return _inverse_block(y_re, y_im, b), head, fdl_re, fdl_im


# --- Non-uniform (two-level Gardner) form ------------------------------


def nupols_tail_partitions(ir_length: int, block_size: int,
                           k: int) -> int:
    """Number of K*B-sized tail partitions (0 if the K-slot head
    covers the whole IR; callers fall back to the shift form then)."""
    head_taps = k * block_size
    if ir_length <= head_taps:
        return 0
    return -(-(ir_length - head_taps) // head_taps)


def nupols_spectra(ir: jax.Array, block_size: int, k: int):
    """(T, L) IRs -> (head, tail) partition spectra for the nupols
    form: head = exactly K partitions of B taps ((T, K, B+1) planes,
    zero-padded H past L), tail = M partitions of K*B taps padded to
    1 + K*nupols_group_len entries ((T, 1+K*L, K*B+1) planes; the pad
    is zero so every spread-MAC phase reads a static window length).
    Requires L > K*B (else use the shift form;
    nupols_tail_partitions == 0 says so)."""
    t, l = ir.shape
    head_taps = k * block_size
    head_ir = jnp.zeros((t, head_taps), jnp.float32)
    head_ir = head_ir.at[:, : min(l, head_taps)].set(
        ir[:, :head_taps].astype(jnp.float32))
    head = partition_spectra(head_ir, block_size)
    t_re, t_im = partition_spectra(
        ir[:, head_taps:].astype(jnp.float32), head_taps)
    # Pad the tail H to 1 + K*L entries (zeros past M) so every block
    # phase of the spread MAC reads the same static window length and
    # out-of-history reads contribute exactly zero.
    mm = t_re.shape[1]
    want = 1 + k * nupols_group_len(mm, k)
    if want > mm:
        pad = jnp.zeros((t, want - mm, t_re.shape[2]), jnp.float32)
        t_re = jnp.concatenate([t_re, pad], axis=1)
        t_im = jnp.concatenate([t_im, pad], axis=1)
    return head, (t_re, t_im)


def nupols_group_len(m: int, k: int) -> int:
    """Per-block share of the m >= 1 tail slots: the spread MAC reads
    L = ceil((M-1)/K) slots per block (tail spectra padded with zero
    H entries so every phase reads the same static length)."""
    return max(1, -(-(m - 1) // k))


def make_partconv_block_nupols(block_size: int, k: int, m: int):
    """Build the jitted nupols block for static (B, K, M).

    Schedule (second design; the first routed the tail FDL through a
    window-boundary lax.cond whose outputs XLA does not alias -- a
    full-plane copy per block and a doubled device-memory footprint.
    This form has NO conditional on large arrays):

    * the window FFTs run UNCONDITIONALLY every block -- rfft/irfft of
      (T, 2KB) cost microseconds; only their USE is gated
      by `select` on small arrays (spectra, chunk buffers, tail_out);
    * the tail FDL is a doubled, index-negated RING
      (G[j] = ring slot (-j) mod M, j = 0..2M-1; one gated one-slot
      write per plane, duplicated at j and j+M) so the per-phase MAC
      share -- slots for m in [1 + blk*L, 1 + (blk+1)*L) -- is ONE
      contiguous dynamic_slice window of L = nupols_group_len slots,
      paired with the matching (small, dynamic) H window; tail H is
      padded with zero entries past M so every phase reads the same
      static length and padded reads contribute exactly zero.

    State pytree (float32 except the two int32 scalars):
      prev        (T, B)       previous input block (head overlap-save)
      hfdl_re/im  (T, K, B+1)  head FDL (shift form)
      blk         int32        block phase in [0, K)
      latest      int32        ring slot of the newest chunk spectrum
      last_re/im  (T, KB+1)    the newest chunk spectrum itself
      chunk_full  (T, K*B)     the PREVIOUS completed input chunk
      chunk_fill  (T, K*B)     the chunk being accumulated this window
      g_re/g_im   (T, 2M, KB+1) doubled index-negated tail FDL
      acc_re/im   (T, KB+1)    spread partial MAC for the NEXT window
      tail_out    (T, K*B)     tail time-domain output, current window

    The ring write never READS G: the newest spectrum rides the carry
    (last_re/im) and is re-written into its (fire-gated-stationary)
    slot every block -- idempotent on non-fire blocks -- because a
    read-modify-write of the carried G becomes a full-plane copy per
    block in the chained scan (XLA would not alias the buffer).

    Returns block_fn(x, state, hh_re, hh_im, ht_re, ht_im) ->
    (y, state'); ht planes must carry 1 + K*L entries
    (nupols_spectra pads). Module docstring has the alignment
    derivation; the fold-algebra golden and
    test_nupols_equals_shift_form pin it.
    """
    kb = k * block_size
    ell = nupols_group_len(m, k)

    @jax.jit
    def block_fn(x, state, hh_re, hh_im, ht_re, ht_im):
        (prev, hfdl_re, hfdl_im, blk, latest, last_re, last_im,
         chunk_full, chunk_fill,
         g_re, g_im, acc_re, acc_im, tail_out) = state
        b = block_size
        fire = blk == 0

        # Head: the uniform shift form over the first K partitions.
        y_head, hfdl_re, hfdl_im = partconv_block(
            x, prev, hfdl_re, hfdl_im, hh_re, hh_im)

        # Window spectrum, computed every block (cheap), used on fire:
        # at block wK the chunk filled last window is complete, so
        # seg = [X_{w-2}, X_{w-1}] and S = S^T_{w-1}.
        seg = jnp.concatenate([chunk_full, chunk_fill], axis=1)
        spec = jnp.fft.rfft(seg, axis=1)
        sre = spec.real.astype(jnp.float32)
        sim = spec.imag.astype(jnp.float32)

        # Ring write: on fire, advance the slot and take the new
        # spectrum into the carried last_re/im; EVERY block re-writes
        # last into its slot at G index (-latest) mod M and the +M
        # twin -- idempotent on non-fire blocks (same value, same
        # slot), and crucially G is never read before being written,
        # so the DUS can update the carried buffer in place.
        latest = jax.lax.rem(latest + fire.astype(jnp.int32), m)
        last_re = jnp.where(fire, sre, last_re)
        last_im = jnp.where(fire, sim, last_im)
        j_w = jax.lax.rem(m - latest, m)  # (-latest) mod m in [0, m)
        for j in (j_w, j_w + m):
            g_re = jax.lax.dynamic_update_slice_in_dim(
                g_re, last_re[:, None], j, axis=1)
            g_im = jax.lax.dynamic_update_slice_in_dim(
                g_im, last_im[:, None], j, axis=1)

        # Window output: finish last window's spread MAC with the
        # newest (m=0) term and inverse-transform; gated into tail_out
        # on fire.
        h0r = ht_re[:, 0].astype(jnp.float32)
        h0i = ht_im[:, 0].astype(jnp.float32)
        y_re = acc_re + last_re * h0r - last_im * h0i
        y_im = acc_im + last_re * h0i + last_im * h0r
        t_new = jnp.fft.irfft(
            jax.lax.complex(y_re, y_im), 2 * kb, axis=1
        )[:, kb:].astype(jnp.float32)
        tail_out = jnp.where(fire, t_new, tail_out)
        zero = jnp.zeros_like(acc_re)
        acc_re = jnp.where(fire, zero, acc_re)
        acc_im = jnp.where(fire, zero, acc_im)

        # Spread MAC: this phase's L-slot share of the m >= 1 slots,
        # toward the NEXT window. m in [m_lo, m_lo + L) needs ring
        # slots (latest - (m-1)) mod M = G indices
        # (m - 1 - latest) mod M ascending -> one contiguous window
        # starting at (m_lo - 1 - latest) mod M; H entries past M are
        # zero-padded so out-of-history reads contribute nothing.
        m_lo = 1 + blk * ell
        j0 = jax.lax.rem(m_lo - 1 - latest + 2 * m, m)
        gw_re = jax.lax.dynamic_slice_in_dim(g_re, j0, ell, axis=1)
        gw_im = jax.lax.dynamic_slice_in_dim(g_im, j0, ell, axis=1)
        hw_re = jax.lax.dynamic_slice_in_dim(
            ht_re, m_lo, ell, axis=1).astype(jnp.float32)
        hw_im = jax.lax.dynamic_slice_in_dim(
            ht_im, m_lo, ell, axis=1).astype(jnp.float32)
        acc_re = acc_re + jnp.sum(gw_re * hw_re - gw_im * hw_im, axis=1)
        acc_im = acc_im + jnp.sum(gw_re * hw_im + gw_im * hw_re, axis=1)

        # Serve this block's slice of the tail output; rotate and
        # refill the chunk buffers (small selects).
        y = y_head + jax.lax.dynamic_slice_in_dim(
            tail_out, blk * b, b, axis=1)
        chunk_full = jnp.where(fire, chunk_fill, chunk_full)
        chunk_fill = jnp.where(fire, jnp.zeros_like(chunk_fill),
                               chunk_fill)
        chunk_fill = jax.lax.dynamic_update_slice_in_dim(
            chunk_fill, x, blk * b, axis=1)
        blk = jax.lax.rem(blk + 1, k)

        return y, (x, hfdl_re, hfdl_im, blk, latest, last_re, last_im,
                   chunk_full, chunk_fill, g_re, g_im, acc_re, acc_im,
                   tail_out)

    return block_fn


def nupols_init_state(tracks: int, block_size: int, k: int, m: int):
    """Zero state pytree for make_partconv_block_nupols (host-side
    numpy; callers device_put the leaves). The ring starts at slot
    m-1 so the first fire advances it to slot 0 (all-zero history
    reads are harmless either way)."""
    import numpy as np

    kb = k * block_size
    z = np.zeros
    return (z((tracks, block_size), np.float32),
            z((tracks, k, block_size + 1), np.float32),
            z((tracks, k, block_size + 1), np.float32),
            np.int32(0),
            np.int32(m - 1),
            z((tracks, kb + 1), np.float32),
            z((tracks, kb + 1), np.float32),
            z((tracks, kb), np.float32),
            z((tracks, kb), np.float32),
            z((tracks, 2 * m, kb + 1), np.float32),
            z((tracks, 2 * m, kb + 1), np.float32),
            z((tracks, kb + 1), np.float32),
            z((tracks, kb + 1), np.float32),
            z((tracks, kb), np.float32))
