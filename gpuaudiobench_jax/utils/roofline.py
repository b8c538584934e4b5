"""Roofline accounting against the card's published peaks.

Each benchmark declares an algorithmic cost model (FLOPs + minimum
device-memory bytes per block, plus which unit does the work);
combined with the measured on-device block time
(harness/device_timing.py) this yields achieved FLOP/s and bytes/s as a
share of the card's published peaks -- the accounting the reference's
GB/s throughput fields (cuda/bench_base.cu:110-115) gesture at, taken
to a share of peak.

Peaks are kept in one table keyed by ``device_kind``. A device that is
not in the table is an error, not a default: another card's peaks
would make every share wrong without saying so. What the card really
reaches (a large bf16 product, a large copy) is measured beside the
published numbers by the speedoflight category and ``chip_smoke.py``.
"""

from __future__ import annotations

from typing import Any, Dict

# Dense rates, without sparsity, at the full 700 W power limit. A card
# set below that limit cannot hold its top clock under a matrix-heavy
# load, so every share is reported with the card's power limit beside
# it.
H100_SXM = {
    "fp32": 67e12,
    "tf32": 495e12,
    "bf16": 989e12,
    "int8": 1979e12,
    "hbm_bytes_per_sec": 3.35e12,
    "source": "NVIDIA H100 SXM5 data sheet (dense, 700 W)",
}

PEAKS: Dict[str, Dict[str, Any]] = {
    "NVIDIA H100 80GB HBM3": H100_SXM,
}

# Units a cost model may name: the CUDA cores' f32 rate, or the tensor
# cores at one operand type. Data movement alone names "fp32" with
# zero or token FLOPs.
UNITS = ("fp32", "tf32", "bf16", "int8")

# Below this share of EVERY modeled wall, a workload is not
# meaningfully "X-bound" -- the time goes to something the roofline
# does not model (dispatch latency, recurrence-step serialization), and
# the bound label says "latency" instead of picking the least-false
# wall.
LATENCY_BOUND_THRESHOLD_PCT = 20.0


def peaks_for(device_kind: str) -> Dict[str, Any]:
    """Published peaks of ``device_kind``; KeyError for a card not in
    the table."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add "
            "them to utils/roofline.py PEAKS with their source") from None


def roofline_metrics(
    cost: Dict[str, Any],
    device_ms: float,
    device_kind: str,
) -> Dict[str, Any]:
    """Achieved rates vs peak for one block.

    ``cost``: {"flops": N, "hbm_bytes": N, "unit": one of UNITS,
    optional "note"}. ``device_ms``: measured on-device block time (> 0).
    """
    if device_ms <= 0:
        raise ValueError(f"device_ms must be positive, got {device_ms}")
    peaks = peaks_for(device_kind)
    unit = cost.get("unit", "fp32")
    if unit not in UNITS:
        raise ValueError(f"unknown cost unit {unit!r} (one of {UNITS})")
    sec = device_ms / 1e3
    flops = float(cost.get("flops", 0))
    hbm_bytes = float(cost.get("hbm_bytes", 0))
    out: Dict[str, Any] = {
        "device_ms": device_ms,
        "flops_per_block": flops,
        "hbm_bytes_per_block": hbm_bytes,
        "achieved_gflops": flops / sec / 1e9,
        "achieved_gbps": hbm_bytes / sec / 1e9,
        "hbm_pct_of_peak":
            100.0 * (hbm_bytes / sec) / peaks["hbm_bytes_per_sec"],
        "unit": unit,
        "peak_source": peaks["source"],
    }
    walls = {"bandwidth": out["hbm_pct_of_peak"]}
    if flops > 0:
        out["flops_pct_of_peak"] = 100.0 * (flops / sec) / peaks[unit]
        walls["compute"] = out["flops_pct_of_peak"]
    # Which wall is closest: the workload is X-bound -- but only when
    # it actually approaches a wall; below the threshold the label says
    # "latency" and nearest_wall keeps the ranking available.
    nearest = max(walls, key=walls.get)
    out["nearest_wall"] = nearest
    out["nearest_wall_pct"] = walls[nearest]
    out["bound"] = (
        nearest if walls[nearest] >= LATENCY_BOUND_THRESHOLD_PCT
        else "latency"
    )
    if "note" in cost:
        out["note"] = cost["note"]
    return out
