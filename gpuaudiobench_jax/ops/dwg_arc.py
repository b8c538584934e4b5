"""Arc-window digital-waveguide block: DWG's one implementation.

A per-sample scan over the block (the reference's loop order) runs S
dependent steps, each a gather and a scatter on every rail. This form
exploits the reference's writePos=0 block semantics
(cuda/bench_dwg.cu:339 -- every block re-walks cur = n % L over the
evolved rails):

* Long waveguides (L >= S, S = bufferSize): cur = n, so each fwd rail
  position n is read and written exactly once per block, at sample n,
  and each bwd position (n + L/2) % L likewise. The sequential scan
  collapses to ELEMENTWISE ops on (G, S):

      f = damp * fwd[:, :S] + inj        b = damp * bwd_window + inj
      fwd[:, :S] = refl * b              bwd_window = refl * f
      out[n] += (f + b) * 0.5  where n == out_tap

  The only non-elementwise work is gathering/scattering the bwd
  circular window [L/2, L/2 + S) mod L -- done once per block as
  O(log W) masked binary rolls (static per-row shift = L/2), instead
  of per-sample one-hot passes.

* Short waveguides (L < S): position p is touched at n = p, p+L,
  p+2L, ... -- within-block chains of lag L with depth at most
  D = ceil(S / Lmin) (6 at the CUDA defaults, Lmin=100). In
  natural-time coordinates the reads are

      ReadF(n) = fwd[n]              for n <  L   (rail seed, direct)
               = refl * b(n - L)     for n >= L   (in-block, lag L)

  and symmetrically for ReadB (seeded by the circular window
  [L/2, L/2 + S) of the bwd rail). D fixed-point rounds of elementwise
  updates + one static per-row binary roll per rail per round converge
  exactly (round r settles all samples n < (r+1)*L; extra rounds are
  idempotent).

Callers pre-partition rows (long first) and pass ``n_long`` statically;
models/dwg.py applies a stable partition permutation to all
per-waveguide parameters at setup. The permutation is a pure waveguide
relabeling: the mono output sum and the per-row rail validation are
both permutation-consistent.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

MIX = 0.5  # WAVEGUIDE_MIX_FACTOR (cuda/benchmark_constants.cuh)


def _row_roll_left(a: jax.Array, shifts: jax.Array) -> jax.Array:
    """Rotate each row of (G, W) left by shifts[g] in [0, W).

    Binary decomposition: log2(W) static rolls, each kept or discarded
    per row by a mask -- full-width elementwise passes, no gather.
    """
    w = a.shape[1]
    nbits = max(1, (w - 1).bit_length())
    shifts = shifts.astype(jnp.int32).reshape(-1, 1)
    for k in range(nbits):
        bit = ((shifts >> k) & 1) == 1
        a = jnp.where(bit, jnp.roll(a, -(1 << k), axis=1), a)
    return a


def _row_roll_right(a: jax.Array, shifts: jax.Array) -> jax.Array:
    w = a.shape[1]
    nbits = max(1, (w - 1).bit_length())
    shifts = shifts.astype(jnp.int32).reshape(-1, 1)
    for k in range(nbits):
        bit = ((shifts >> k) & 1) == 1
        a = jnp.where(bit, jnp.roll(a, 1 << k, axis=1), a)
    return a


def _long_path(x, fwd, bwd, lengths, in_taps, out_taps, gains, refl, damp):
    """All rows have L >= S. Returns (out (S,), fwd', bwd')."""
    s = x.shape[0]
    w = fwd.shape[1]
    ll = lengths.astype(jnp.int32).reshape(-1, 1)
    half = ll // 2
    it = in_taps.astype(jnp.int32).reshape(-1, 1)
    ot = out_taps.astype(jnp.int32).reshape(-1, 1)
    ga = gains.reshape(-1, 1)
    rf = refl.reshape(-1, 1)
    da = damp.reshape(-1, 1)
    col_s = jnp.arange(s, dtype=jnp.int32)[None, :]

    # Gather the bwd window: q(j) = (half + j) % L for j in [0, S).
    # Unwrapped part (j < L - half): rotate left by half.
    # Wrapped part (j >= L - half): q = half + j - L -> rotate left by
    # W + half - L (in [0, W) since 0 < L - half and half < L <= W).
    r1 = _row_roll_left(bwd, half.ravel())[:, :s]
    r2 = _row_roll_left(bwd, (w + half - ll).ravel())[:, :s]
    bwd_win = jnp.where(col_s >= (ll - half), r2, r1)

    inj = jnp.where(col_s == it, x[None, :] * ga, jnp.float32(0))
    f = da * fwd[:, :s] + inj
    b = da * bwd_win + inj
    out = jnp.sum(
        jnp.where(col_s == ot, (f + b) * jnp.float32(MIX), jnp.float32(0)),
        axis=0,
    )

    fwd_new = jnp.concatenate([rf * b, fwd[:, s:]], axis=1) if w > s \
        else (rf * b)[:, :w]

    # Scatter refl*f back to the bwd window (inverse of the gather).
    p = jnp.pad(rf * f, ((0, 0), (0, w - s)))
    col_w = jnp.arange(w, dtype=jnp.int32)[None, :]
    s1 = _row_roll_right(p, half.ravel())       # q >= half: j = q - half
    s2 = _row_roll_left(p, (ll - half).ravel())  # q < half: j = q + L - half
    m1 = (col_w >= half) & (col_w < ll) & (col_w - half < s)
    m2 = (col_w < half) & (col_w + ll - half < s)
    bwd_new = jnp.where(m1, s1, jnp.where(m2, s2, bwd))
    return out, fwd_new, bwd_new


def _short_core(x, read_f0, read_b0, lengths, in_taps, out_taps, gains,
                refl, damp, n_rounds: int):
    """Fixed-point over in-block lag-L chains for rows with L < S.

    ``read_f0``/``read_b0``: the values ReadF/ReadB(n) fetch for n < L
    (junk beyond; overwritten by the in-block feedback). Returns
    (out (S,), f, b) -- the final per-sample f/b streams, from which
    callers derive stored values (refl*b, refl*f).
    """
    s = x.shape[0]
    ll = lengths.astype(jnp.int32).reshape(-1, 1)
    it = in_taps.astype(jnp.int32).reshape(-1, 1)
    ot = out_taps.astype(jnp.int32).reshape(-1, 1)
    ga = gains.reshape(-1, 1)
    rf = refl.reshape(-1, 1)
    da = damp.reshape(-1, 1)
    col = jnp.arange(s, dtype=jnp.int32)[None, :]
    cur = col - (col // ll) * ll  # n % L, elementwise

    inj = jnp.where(cur == it, x[None, :] * ga, jnp.float32(0))
    in_block = col >= ll

    f = da * read_f0 + inj  # round 0: correct for n < L
    b = da * read_b0 + inj
    for _ in range(max(0, n_rounds - 1)):
        # lag-L feedback: ReadF(n>=L) = refl*b(n-L), ReadB likewise.
        fb = rf * _row_roll_right(b, ll.ravel())
        bb = rf * _row_roll_right(f, ll.ravel())
        f = da * jnp.where(in_block, fb, read_f0) + inj
        b = da * jnp.where(in_block, bb, read_b0) + inj

    out = jnp.sum(
        jnp.where(cur == ot, (f + b) * jnp.float32(MIX), jnp.float32(0)),
        axis=0,
    )
    return out, f, b


def _short_path(x, fwd, bwd, lengths, in_taps, out_taps, gains, refl, damp,
                n_rounds: int):
    """All rows have L < S. Rails arrive width-S (callers pad/slice);
    only columns < L are live. Returns (out (S,), fwd', bwd') with
    untouched columns preserved."""
    s = x.shape[0]
    ll = lengths.astype(jnp.int32).reshape(-1, 1)
    half = ll // 2
    rf = refl.reshape(-1, 1)
    col = jnp.arange(s, dtype=jnp.int32)[None, :]

    # Rail seeds. ReadF(n<L) = fwd[:, n] directly (cur = n there).
    # ReadB(n<L) reads the circular window q = (n + half) % L.
    rb1 = _row_roll_left(bwd, half.ravel())
    rb2 = _row_roll_left(bwd, (s + half - ll).ravel() % s)
    read_b0 = jnp.where(col >= (ll - half), rb2, rb1)

    out, f, b = _short_core(
        x, fwd, read_b0, lengths, in_taps, out_taps, gains, refl, damp,
        n_rounds,
    )

    # Write-back: position p's final value is the one stored at
    # n_last(p) = p + L*floor((S-1-p)/L); the coefficient is kmax =
    # floor((S-1)/L) for p <= (S-1) % L, else kmax - 1.
    sf = rf * b  # values stored into fwd at sample n
    sb = rf * f
    kmax = (s - 1) // ll
    rrem = (s - 1) - kmax * ll  # (S-1) % L
    hi_f = _row_roll_left(sf, (kmax * ll).ravel())
    lo_f = _row_roll_left(sf, ((kmax - 1) * ll).ravel() % s)
    live = col < ll
    fwd_new = jnp.where(live & (col <= rrem), hi_f,
                        jnp.where(live, lo_f, fwd))

    # bwd position q was written at n == (q - half) mod L; build the
    # p'-space result then rotate by half within [0, L).
    hi_b = _row_roll_left(sb, (kmax * ll).ravel())
    lo_b = _row_roll_left(sb, ((kmax - 1) * ll).ravel() % s)
    tmp = jnp.where(col <= rrem, hi_b, lo_b)  # tmp[p'] valid for p' < L
    w1 = _row_roll_right(tmp, half.ravel())       # q >= half: p' = q - half
    w2 = _row_roll_left(tmp, (ll - half).ravel())  # q < half: p' = q + L - half
    bwd_new = jnp.where(live, jnp.where(col >= half, w1, w2), bwd)
    return out, fwd_new, bwd_new


@functools.partial(jax.jit, static_argnames=("n_long", "n_rounds"))
def dwg_block_arc(
    x: jax.Array,        # (S,) mono input block
    fwd: jax.Array,      # (G, W) forward rail, rows partitioned long-first
    bwd: jax.Array,      # (G, W) backward rail
    lengths: jax.Array,  # (G,) int32
    input_taps: jax.Array,
    output_taps: jax.Array,
    gains: jax.Array,
    reflections: jax.Array,
    dampings: jax.Array,
    *,
    n_long: int,         # static: rows [0, n_long) have L >= S
    n_rounds: int = 0,   # static: ceil(S / min short L); 0 if no short rows
):
    """One block over rails (G, L_max): (out (S,), fwd', bwd'), the
    semantics of models/dwg.py dwg_reference."""
    g, w = fwd.shape
    s = x.shape[0]
    if n_long < g and n_rounds < 2:
        raise ValueError(
            "short waveguides present (L < S) but n_rounds < 2: pass "
            "n_rounds = ceil(S / min(short L)) or the fixed point cannot "
            "converge (results would be silently wrong)"
        )

    out = jnp.zeros((s,), jnp.float32)
    fwd_parts, bwd_parts = [], []

    if n_long > 0:
        out_l, fwd_l, bwd_l = _long_path(
            x, fwd[:n_long], bwd[:n_long],
            lengths[:n_long], input_taps[:n_long], output_taps[:n_long],
            gains[:n_long], reflections[:n_long], dampings[:n_long],
        )
        out = out + out_l
        fwd_parts.append(fwd_l)
        bwd_parts.append(bwd_l)

    if n_long < g:
        # Short rows only ever touch positions < L < S; work at width S.
        ws = min(w, s)
        fwd_s_in, bwd_s_in = fwd[n_long:, :ws], bwd[n_long:, :ws]
        if ws < s:
            fwd_s_in = jnp.pad(fwd_s_in, ((0, 0), (0, s - ws)))
            bwd_s_in = jnp.pad(bwd_s_in, ((0, 0), (0, s - ws)))
        out_s, fwd_s, bwd_s = _short_path(
            x, fwd_s_in, bwd_s_in,
            lengths[n_long:], input_taps[n_long:], output_taps[n_long:],
            gains[n_long:], reflections[n_long:], dampings[n_long:],
            n_rounds,
        )
        out = out + out_s
        fwd_s, bwd_s = fwd_s[:, :ws], bwd_s[:, :ws]
        if ws < w:
            fwd_s = jnp.concatenate([fwd_s, fwd[n_long:, ws:]], axis=1)
            bwd_s = jnp.concatenate([bwd_s, bwd[n_long:, ws:]], axis=1)
        fwd_parts.append(fwd_s)
        bwd_parts.append(bwd_s)

    fwd_new = fwd_parts[0] if len(fwd_parts) == 1 \
        else jnp.concatenate(fwd_parts, axis=0)
    bwd_new = bwd_parts[0] if len(bwd_parts) == 1 \
        else jnp.concatenate(bwd_parts, axis=0)
    return out, fwd_new, bwd_new


# ---------------------------------------------------------------------------
# Streaming form: in steady state the positional-rail scatter of block k
# is immediately gathered back (same static offsets) by block k+1, so
# the chained state can stay in ALIGNED stored-value form and the rolls
# cancel entirely for long rows:
#
#   SF[g, n] = the value ReadF will fetch at block-local step n
#            = fwd[cur(n)] in positional terms = refl * b_prev(g, n)
#   (SB analogous via the bwd window). Long rows (L >= S): the stream
#   step is PURE elementwise -- f = damp*SF + inj; SF' = refl*b.
#   Short rows (L < S): reads at n < L fetch the previous block's
#   stored value at column n + L*floor((S-1-n)/L) (a 2-roll static
#   gather), then the usual fixed-point rounds.
# ---------------------------------------------------------------------------

def dwg_stream_entry(fwd, bwd, lengths, s: int):
    """NumPy: positional rails -> aligned (SF, SB) stream carry (G, S).

    Unified for long and short rows: SF[g, j] = fwd[g, j % L] and
    SB[g, j] = bwd[g, (j + L//2) % L] -- the value a read at
    block-local step j fetches. One host-side gather at stream entry;
    no per-block rolls afterwards for long rows.
    """
    import numpy as np

    g = fwd.shape[0]
    ll = lengths.astype(np.int64)[:, None]
    j = np.arange(s, dtype=np.int64)[None, :]
    rows = np.arange(g)[:, None]
    sf = fwd[rows, j % ll].astype(np.float32)
    sb = bwd[rows, (j + ll // 2) % ll].astype(np.float32)
    return sf, sb


@functools.partial(jax.jit, static_argnames=("n_long", "n_rounds"))
def dwg_stream_step(
    x: jax.Array,    # (S,)
    sf: jax.Array,   # (G, S) aligned stored-value carry
    sb: jax.Array,
    lengths: jax.Array,
    input_taps: jax.Array,
    output_taps: jax.Array,
    gains: jax.Array,
    reflections: jax.Array,
    dampings: jax.Array,
    *,
    n_long: int,
    n_rounds: int = 0,
):
    """One streaming block on the aligned carry: (out (S,), sf', sb')."""
    g, s = sf.shape
    if n_long < g and n_rounds < 2:
        raise ValueError(
            "short waveguides present (L < S) but n_rounds < 2: pass "
            "n_rounds = ceil(S / min(short L)) or the fixed point cannot "
            "converge (results would be silently wrong)"
        )

    col = jnp.arange(s, dtype=jnp.int32)[None, :]
    out = jnp.zeros((s,), jnp.float32)
    sf_parts, sb_parts = [], []

    if n_long > 0:
        it = input_taps[:n_long].astype(jnp.int32).reshape(-1, 1)
        ot = output_taps[:n_long].astype(jnp.int32).reshape(-1, 1)
        ga = gains[:n_long].reshape(-1, 1)
        rf = reflections[:n_long].reshape(-1, 1)
        da = dampings[:n_long].reshape(-1, 1)
        inj = jnp.where(col == it, x[None, :] * ga, jnp.float32(0))
        f = da * sf[:n_long] + inj
        b = da * sb[:n_long] + inj
        out = out + jnp.sum(
            jnp.where(col == ot, (f + b) * jnp.float32(MIX), jnp.float32(0)),
            axis=0,
        )
        sf_parts.append(rf * b)
        sb_parts.append(rf * f)

    if n_long < g:
        ll = lengths[n_long:].astype(jnp.int32).reshape(-1, 1)
        rf = reflections[n_long:].reshape(-1, 1)
        # Previous block's stored value for reads at n < L lives at
        # column n + L*kmax(n) (kmax for n <= (S-1)%L, else kmax-1).
        kmax = (s - 1) // ll
        rrem = (s - 1) - kmax * ll
        sel = col <= rrem

        def gather(a):
            hi = _row_roll_left(a, (kmax * ll).ravel())
            lo = _row_roll_left(a, ((kmax - 1) * ll).ravel() % s)
            return jnp.where(sel, hi, lo)

        out_s, f, b = _short_core(
            x, gather(sf[n_long:]), gather(sb[n_long:]),
            lengths[n_long:], input_taps[n_long:], output_taps[n_long:],
            gains[n_long:], reflections[n_long:], dampings[n_long:],
            n_rounds,
        )
        out = out + out_s
        sf_parts.append(rf * b)
        sb_parts.append(rf * f)

    sf_new = sf_parts[0] if len(sf_parts) == 1 \
        else jnp.concatenate(sf_parts, axis=0)
    sb_new = sb_parts[0] if len(sb_parts) == 1 \
        else jnp.concatenate(sb_parts, axis=0)
    return out, sf_new, sb_new
