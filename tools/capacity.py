"""Real-time capacity search: the largest workload the card sustains.

The DAFx-24 poster's underlying question is "at what scale does GPU
audio still make the buffer deadline?" (the Conv1D pass/fail example,
media/dafx24/index.html:420-436, and the tab4/tab6 size sweeps). This
tool answers it directly: binary-search a workload knob (modal modes,
track count) for the largest value whose SATURATED p99 stays at or
under the buffer deadline (1000*bufferSize/fs ms, cuda/globals.cu:55).

The saturated tier is the criterion because it measures what the
card sustains block after block; a single-block round trip adds the
host's dispatch and transfer cost once per block. Device timing is
disabled during the search (it costs a trace pass per probe) and
re-enabled for one confirmation run at the found capacity, which is
what gets archived.

Usage:
  python tools/capacity.py --benchmark ModalFilterBank
  python tools/capacity.py --benchmark Conv1D --bufferSize 64
  python tools/capacity.py --benchmark IIRFilter --hi 16384 --json out.json

Search semantics: the measured pass/fail is assumed monotone in the
knob (bigger workload is never faster). Geometric ascent from --lo
until the first miss, then bisection to the --quantum granularity
(128 tracks; 1024 modes), bounded by --maxEvals
probes since every probe is a fresh compile + measured run.
"""

from __future__ import annotations

import _pathfix  # noqa: F401,E402 - repo-root sys.path (tools/_pathfix.py)

import argparse
import json
import os
import sys

# benchmark -> (BenchConfig field, lo, hi, quantum). Everything not
# listed scales on the track axis.
KNOBS = {
    "ModalFilterBank": ("modal_num_modes", 1024, 1 << 24, 1024),
    # FDL + IR spectra are ~0.77 MB/track at the 1 s default IR
    # (2 planes x 2 arrays x 94 x 513 x 4 B); 12288 tracks is ~9.5 GB.
    # Past the hi an allocation failure would masquerade as a deadline
    # miss.
    "PartConv": ("n_tracks", 128, 12288, 128),
    # FDTD3D's load axis is the room, not the track count (one shared
    # acoustic field; --fdtdRoom, grid = room + 2). hi = 112 bounds
    # the search at a 114^3 grid.
    "FDTD3D": ("fdtd_room", 16, 112, 2),
}
TRACK_KNOB = ("n_tracks", 128, 1 << 16, 128)
EXCLUDED = ("NoOp", "SOL_", "datacopy")


def quantize(v: int, quantum: int, lo: int) -> int:
    return max(lo, (v // quantum) * quantum)


def classify_wall(err: str) -> str:
    """What actually stopped a failed probe. 'deadline' misses never
    raise, so an exception means the wall is NOT the reference's
    criterion -- say which infrastructure wall it was:
      memory    -- device allocation (RESOURCE_EXHAUSTED / OOM);
      error     -- anything else (investigate the probe record)."""
    low = err.lower()
    if ("RESOURCE_EXHAUSTED" in err or "out of memory" in low
            or "out_of_memory" in low):
        return "memory"
    return "error"


def search_capacity(evaluate, lo, hi, quantum, max_evals):
    """Largest v in [lo, hi] (quantum grid) with evaluate(v) True.

    evaluate(v) -> bool, assumed monotone (True below some threshold).
    Returns (capacity, probes, ceiling_hit):
      capacity     None if even lo fails; otherwise the largest passing
                   value the probe budget could certify.
      probes       [(value, passed), ...] in evaluation order.
      ceiling_hit  True if hi itself passed (real capacity may exceed hi).
    """
    if lo % quantum or hi % quantum:
        raise ValueError("lo and hi must be multiples of quantum")
    if lo > hi:
        raise ValueError("lo > hi")
    probes = []

    def ev(v):
        ok = bool(evaluate(v))
        probes.append((v, ok))
        return ok

    if not ev(lo):
        return None, probes, False
    good, bad = lo, None
    # Geometric ascent: doubling finds the miss region in log probes.
    v = lo
    while v < hi and len(probes) < max_evals:
        v = min(v * 2, hi)
        if ev(v):
            good = v
        else:
            bad = v
            break
    # Bisection between the last pass and the first miss.
    while bad is not None and bad - good > quantum and len(probes) < max_evals:
        mid = quantize((good + bad) // 2, quantum, lo)
        if mid <= good or mid >= bad:
            break
        if ev(mid):
            good = mid
        else:
            bad = mid
    return good, probes, bad is None and good == hi


def knob_for(benchmark: str):
    if any(benchmark.startswith(p) for p in EXCLUDED):
        raise SystemExit(
            f"{benchmark}: no capacity knob (NoOp/speedoflight measure "
            "overhead, not load; datacopy* are round-trip transfer "
            "benchmarks with no saturated tier)")
    return KNOBS.get(benchmark, TRACK_KNOB)


def harness_probe(benchmark, field, args, device_timing=False):
    """Returns evaluate(value) -> (sustains, detail dict)."""
    from gpuaudiobench_jax.config import BenchConfig
    from gpuaudiobench_jax.harness.runner import run_benchmark
    from gpuaudiobench_jax.registry import create_benchmark

    def evaluate(value):
        cfg = BenchConfig(
            fs=args.fs,
            buffer_size=args.bufferSize,
            n_runs=args.nRuns,
            warmup=args.warmup,
            pipeline_depth=args.pipelineDepth,
            saturated_reps=args.satReps,
            verification=args.verification,
            write_latencies=False,
            quiet=True,
            device_timing=device_timing,
            **dict(parse_overrides(args.set), **{field: value}),
        )
        b = create_benchmark(benchmark, cfg)
        b.setup()
        r = run_benchmark(b, cfg, verbose=False)
        valid = r.validation is None or r.validation.passed
        ss = r.saturated_statistics
        p99 = ss.p99 if ss else float("inf")
        deadline = cfg.deadline_ms() * (1.0 - args.margin)
        detail = {
            "value": value,
            "saturated_p50_ms": round(ss.median, 4) if ss else None,
            "saturated_p99_ms": round(p99, 4) if ss else None,
            "valid": valid,
            "device_p50_ms": (round(r.device_statistics.median, 4)
                              if r.device_statistics else None),
            # Timing-method label: a wall-method "device" number must
            # never render unmarked beside xplane numbers (VERDICT r3
            # weak #6; the 66.7 ms DWG1DNaive row).
            "device_method": (r.device_timing_method
                              if r.device_statistics else None),
        }
        return valid and p99 <= deadline, detail

    return evaluate


def parse_overrides(pairs):
    """--set FIELD=VALUE list -> BenchConfig kwargs, coerced to the
    dataclass field's type (unknown fields raise with the field list,
    so a typo cannot silently probe the default config)."""
    import dataclasses

    from gpuaudiobench_jax.config import BenchConfig

    types = {f.name: f.type for f in dataclasses.fields(BenchConfig)}
    out = {}
    for pair in pairs:
        if "=" not in pair:
            raise SystemExit(f"--set needs FIELD=VALUE, got {pair!r}")
        name, raw = pair.split("=", 1)
        if name not in types:
            raise SystemExit(
                f"--set: unknown BenchConfig field {name!r}")
        t = types[name]
        if t in ("bool", bool):
            out[name] = raw.lower() in ("1", "true", "yes", "on")
        elif t in ("int", int) or "int" in str(t):
            out[name] = int(raw)
        elif t in ("float", float) or "float" in str(t):
            out[name] = float(raw)
        else:
            out[name] = raw
    return out


def run_confirm_only(benchmark: str, args) -> dict:
    """No search: archive-grade confirmation probe(s) at explicit knob
    value(s) (--confirmOnly v1[,v2,...]) with device timing on.

    The r4->r5 confirm discipline (VERDICT r4 next #4/#6): every
    capacity row gets a FRESH-PROCESS, validation-on confirm at its
    certified size -- run each invocation of this mode in its own
    process (arena fragmentation from a prior search in the same
    process measured 14x paging slowdowns / RESOURCE_EXHAUSTED).
    Use --satReps >= 101 for boundary sizes so the p99 is a real
    percentile, not max-of-21.
    """
    field = args.knob or knob_for(benchmark)[0]
    if args.knob:
        parse_overrides([f"{field}=0"])  # existence check (typed)
    deadline = 1000.0 * args.bufferSize / args.fs
    values = [int(v) for v in str(args.confirmOnly).split(",")]
    probe = harness_probe(benchmark, field, args, device_timing=True)
    confirms = []
    for v in values:
        print(f"confirm: {benchmark} {field}={v} "
              f"(satReps {args.satReps}, verification "
              f"{args.verification})", flush=True)
        try:
            ok, d = probe(v)
            d["sustains"] = ok
        except Exception as e:  # noqa: BLE001 - record, don't crash
            d = {"value": v, "saturated_p99_ms": None, "sustains": False,
                 "error": f"{type(e).__name__}: {e}",
                 "wall_class": classify_wall(str(e))}
        confirms.append(d)
        print(f"  {field}={v}: sat p50 {d.get('saturated_p50_ms')} "
              f"p99 {d.get('saturated_p99_ms')} ms vs {deadline:.3f} -> "
              f"{'sustains' if d['sustains'] else 'MISSES'}", flush=True)
    record = {
        "benchmark": benchmark,
        "knob": field,
        "kind": "confirm",
        "deadline_ms": deadline,
        "buffer_size": args.bufferSize,
        "fs": args.fs,
        "pipeline_depth": args.pipelineDepth,
        "saturated_reps": args.satReps,
        "config_overrides": parse_overrides(args.set),
        "confirms": confirms,
    }
    return record


def run_one(benchmark: str, args) -> dict:
    """Search one benchmark's capacity; returns the JSON-able record."""
    if getattr(args, "confirmOnly", ""):
        return run_confirm_only(benchmark, args)
    if args.knob:
        # Explicit knob (e.g. ir_length for the real-time IR-length
        # capacity of PartConv): caller supplies the range.
        if args.lo is None or args.hi is None or args.quantum is None:
            raise SystemExit("--knob requires --lo/--hi/--quantum")
        field, lo, hi, quantum = (args.knob, args.lo, args.hi,
                                  args.quantum)
        parse_overrides([f"{field}=0"])  # existence check (typed)
    else:
        field, lo, hi, quantum = knob_for(benchmark)
        lo = args.lo if args.lo is not None else lo
        hi = args.hi if args.hi is not None else hi
        quantum = args.quantum if args.quantum is not None else quantum
    deadline = 1000.0 * args.bufferSize / args.fs

    print(f"capacity: {benchmark} knob={field} range=[{lo}, {hi}] "
          f"quantum={quantum} deadline={deadline:.3f} ms "
          f"(buffer {args.bufferSize} @ {args.fs} Hz, margin {args.margin})")

    probe = harness_probe(benchmark, field, args)
    details = []

    def flush_partial():
        # Large-workload probes run tens of minutes each; a batch
        # timeout (SIGTERM) mid-bisection must not lose hours of probe
        # evidence. After every probe, persist the trace-so-far next
        # to the final JSON; a re-run narrows lo/hi from it. Removed
        # on successful completion (main writes the real record).
        if not getattr(args, "json", None):
            return
        with open(args.json + ".partial", "w") as f:
            json.dump({"benchmark": benchmark, "knob": field,
                       "incomplete": True, "probes": details}, f,
                      indent=2)

    def evaluate(v):
        # A probe that dies at a boundary size (e.g. RESOURCE_EXHAUSTED
        # on an over-HBM allocation) is infeasible, not a tool crash.
        try:
            ok, d = probe(v)
        except Exception as e:  # noqa: BLE001 - any probe failure = miss
            details.append({"value": v,
                            "error": f"{type(e).__name__}: {e}",
                            "wall_class": classify_wall(str(e))})
            flush_partial()
            print(f"  probe {field}={v}: FAILED ({type(e).__name__}) "
                  "-> treated as infeasible", file=sys.stderr)
            return False
        details.append(d)
        flush_partial()
        print(f"  probe {field}={v}: sat p99 "
              f"{d['saturated_p99_ms']} ms -> "
              f"{'sustains' if ok else 'MISSES' if d['valid'] else 'INVALID'}")
        if not d["valid"]:
            print(f"  WARNING: validation failed at {field}={v}; "
                  "treated as infeasible but investigate", file=sys.stderr)
        return ok

    capacity, probes, ceiling = search_capacity(
        evaluate, lo, hi, quantum, args.maxEvals)

    confirm = None
    if capacity is not None:
        # Archive-grade confirmation at the found capacity with device
        # timing on (the searched probes skip it for speed). Release
        # everything the search held first: near an HBM wall the failed
        # over-capacity probes leave the arena fragmented enough that a
        # size which passed as a probe can RESOURCE_EXHAUSTED as the
        # confirmation.
        import gc

        import jax

        gc.collect()
        jax.clear_caches()
        cargs = argparse.Namespace(**vars(args))
        if args.confirmVerification:
            cargs.verification = args.confirmVerification
        try:
            ok, confirm = harness_probe(
                benchmark, field, cargs, device_timing=True)(capacity)
            confirm["sustains"] = ok
        except Exception as e:  # noqa: BLE001
            confirm = {"value": capacity, "saturated_p99_ms": None,
                       "error": f"{type(e).__name__}: {e}"}
            print(f"  confirmation at {field}={capacity} FAILED: {e}",
                  file=sys.stderr)

    # Budget-ended searches are lower bounds, not capacities, and must
    # say so. Two cases: (a) ascent exhausted -- no miss was ever
    # observed and hi was not reached; (b) bisection exhausted -- a miss
    # WAS observed but the pass/fail boundary was only localized to a
    # gap coarser than --quantum.
    fail_vals = [v for v, ok in probes if not ok]
    pass_vals = [v for v, ok in probes if ok]
    boundary_gap = (min(fail_vals) - max(pass_vals)
                    if fail_vals and pass_vals else None)
    # Which wall bounds the reported capacity: the deadline (a probe
    # that RAN and missed), or an infrastructure wall (the bounding
    # probe raised -- memory/error via classify_wall).
    wall_class = None
    if fail_vals:
        bounding = min(fail_vals)
        for d in details:
            if d.get("value") == bounding and "error" in d:
                wall_class = d["wall_class"]
                break
        else:
            wall_class = "deadline"
    budget_exhausted = (capacity is not None and not ceiling
                        and (not fail_vals
                             or (boundary_gap is not None
                                 and boundary_gap > quantum)))
    record = {
        "benchmark": benchmark,
        "knob": field,
        "capacity": capacity,
        "ceiling_hit": ceiling,
        "budget_exhausted": budget_exhausted,
        "boundary_gap": boundary_gap,
        "deadline_ms": deadline,
        "margin": args.margin,
        "buffer_size": args.bufferSize,
        "fs": args.fs,
        "pipeline_depth": args.pipelineDepth,
        "saturated_reps": args.satReps,
        "config_overrides": parse_overrides(args.set),
        "wall_class": wall_class,
        "probes": details,
        "confirmation": confirm,
    }

    if capacity is None:
        print(f"RESULT: {benchmark} misses deadline even at {field}={lo}")
        return record
    if ceiling:
        qualifier = " (>= search ceiling; raise --hi)"
    elif budget_exhausted and fail_vals:
        qualifier = (f" (>= only: budget ended bisection with the "
                     f"boundary localized to a {boundary_gap}-wide gap, "
                     f"not --quantum {quantum}; raise --maxEvals)")
    elif budget_exhausted:
        qualifier = (" (>= only: probe budget exhausted before a miss; "
                     "raise --maxEvals)")
    else:
        qualifier = ""
    if wall_class and wall_class != "deadline":
        qualifier += (f" [bounded by a {wall_class} wall, not the "
                      "deadline]")
    print(f"RESULT: {benchmark} sustains {field}={capacity}{qualifier} "
          f"at buffer {args.bufferSize} @ {args.fs} Hz "
          f"(sat p99 {confirm['saturated_p99_ms']} ms vs "
          f"{deadline:.3f} ms deadline"
          + (f", device p50 {confirm['device_p50_ms']} ms" if
             confirm.get("device_p50_ms") is not None else "") + ")")
    if confirm is not None and not confirm.get("sustains", True):
        print("NOTE: confirmation run regressed past the deadline; the "
              "boundary is noise-adjacent — re-run with --margin 0.05",
              file=sys.stderr)
    return record


def render_md(records, path=None):
    """Markdown table of capacity records (docs artifact). Returns the
    markdown string; writes it to `path` when one is given."""
    lines = [
        "# Real-time capacity (saturated p99 vs buffer deadline)",
        "",
        f"Deadline {records[0]['deadline_ms']:.3f} ms (buffer "
        f"{records[0]['buffer_size']} @ {records[0]['fs']} Hz); criterion "
        "= largest knob value whose saturated p99 meets it "
        "(tools/capacity.py).",
        "",
        "| Benchmark | Knob | Capacity | sat p50 ms | sat p99 ms |"
        " device p50 ms [method] | note |",
        "|---|---|---:|---:|---:|---:|---|",
    ]
    for r in records:
        c = r.get("confirmation") or {}
        if r["ceiling_hit"]:
            note = ">= search ceiling"
        elif r["capacity"] is None:
            note = "below lo"
        elif r.get("budget_exhausted"):
            gap = r.get("boundary_gap")
            note = (f">= only (budget; boundary gap {gap})"
                    if gap is not None else ">= only (budget)")
        else:
            note = ""
        wc = r.get("wall_class")
        if wc and wc != "deadline":
            wall = f"{wc} wall"
            note = f"{note}; {wall}" if note else wall
        over = r.get("config_overrides") or {}
        if over:
            pairs = " ".join(f"{k}={v}" for k, v in sorted(over.items()))
            note = f"{note}; {pairs}" if note else pairs
        dev = c.get("device_p50_ms")
        meth = c.get("device_method")
        dev_s = ("—" if dev is None
                 else f"{dev} [{meth}]" if meth else f"{dev}")
        # Bracketed boundary rows (VERDICT r4 next #4): the Capacity
        # cell carries the CERTIFIED point and names the edge, so the
        # machine-readable table can never flatter the endpoint.
        br = r.get("bracket")
        cap_s = (f"{r['capacity']} (edge {br['edge']})" if br
                 else f"{r['capacity'] if r['capacity'] is not None else '—'}")
        if br:
            note = f"{note}; {br['note']}" if note else br["note"]
        if r.get("confirm_reps"):
            conf_note = f"confirm n={r['confirm_reps']}"
            note = f"{note}; {conf_note}" if note else conf_note
        lines.append(
            f"| {r['benchmark']} | {r['knob']} | "
            f"{cap_s} | "
            f"{c.get('saturated_p50_ms', '—')} | "
            f"{c.get('saturated_p99_ms', '—')} | "
            f"{dev_s} | {note} |")
    text = "\n".join(lines) + "\n"
    if path is not None:
        with open(path, "w") as f:
            f.write(text)
        print(f"written: {path}")
    return text


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--benchmark", required=True, action="append",
                    help="repeatable; with several benchmarks the "
                         "per-benchmark default ranges apply "
                         "(--lo/--hi/--quantum must be unset)")
    ap.add_argument("--fs", type=int, default=48000)
    ap.add_argument("--bufferSize", type=int, default=512)
    ap.add_argument("--lo", type=int, default=None)
    ap.add_argument("--hi", type=int, default=None)
    ap.add_argument("--quantum", type=int, default=None)
    ap.add_argument("--maxEvals", type=int, default=12,
                    help="probe budget; each probe is a compile + run")
    ap.add_argument("--nRuns", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--pipelineDepth", type=int, default=256)
    ap.add_argument("--satReps", type=int, default=11)
    ap.add_argument("--verification", default="spot",
                    help="validation mode during search probes; 'none' "
                         "skips the host golden (linear in workload size "
                         "-- minutes at 10M+ modes)")
    ap.add_argument("--confirmVerification", default="",
                    help="validation mode for the confirmation run at "
                         "the found capacity (default: same as "
                         "--verification); use 'spot' with "
                         "'--verification none' to search fast but "
                         "archive a validated point")
    ap.add_argument("--margin", type=float, default=0.0,
                    help="safety fraction shaved off the deadline "
                         "(0.1 = require p99 <= 90%% of deadline); the "
                         "reference criterion is exactly p99 <= deadline")
    ap.add_argument("--json", default="",
                    help="write the search record(s) to this path (one "
                         "object for a single benchmark, a list for "
                         "several)")
    ap.add_argument("--md", default="",
                    help="write a markdown capacity table to this path")
    ap.add_argument("--set", action="append", default=[],
                    metavar="FIELD=VALUE",
                    help="BenchConfig override applied to every probe "
                         "(e.g. --set partconv_form=nupols); recorded "
                         "in the JSON as config_overrides")
    ap.add_argument("--knob", default="",
                    metavar="FIELD",
                    help="search this BenchConfig field instead of the "
                         "benchmark's default knob (requires "
                         "--lo/--hi/--quantum)")
    ap.add_argument("--confirmOnly", default="",
                    metavar="V1[,V2,...]",
                    help="no search: run archive-grade confirmation "
                         "probe(s) at these explicit knob values "
                         "(device timing on; one fresh process per "
                         "invocation; --satReps >= 101 for boundary "
                         "certification)")
    args = ap.parse_args(argv)
    from gpuaudiobench_jax.utils.device import enable_compilation_cache

    enable_compilation_cache()

    if len(args.benchmark) > 1 and (args.lo is not None or
                                    args.hi is not None or
                                    args.quantum is not None):
        ap.error("--lo/--hi/--quantum apply to a single --benchmark; "
                 "with several, the per-benchmark defaults are used")

    records = [run_one(b, args) for b in args.benchmark]

    if args.json:
        payload = records[0] if len(records) == 1 else records
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"written: {args.json}")
        partial = args.json + ".partial"
        if os.path.exists(partial):  # superseded by the real record
            os.remove(partial)
    if args.md:
        render_md(records, args.md)
    def ok(r):
        if r.get("kind") == "confirm":
            return all(c.get("sustains") for c in r["confirms"])
        return r["capacity"] is not None

    return 0 if all(ok(r) for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
