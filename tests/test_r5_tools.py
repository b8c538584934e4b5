"""Capacity-ledger tooling: brackets from search + confirmation runs."""

import importlib.util
import json
import os

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _load_tool(name):
    import sys

    tools_dir = os.path.join(ROOT, "tools")
    sys.path.insert(0, tools_dir)  # tools import _pathfix as a sibling
    try:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(tools_dir, f"{name}.py")
        )
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(tools_dir)
    return mod


# ---- build_capacity_ledger ------------------------------------------

def _search_rec(cap=917504):
    return {
        "benchmark": "IIRFilter", "knob": "n_tracks", "capacity": cap,
        "ceiling_hit": False, "budget_exhausted": False,
        "boundary_gap": 16384, "deadline_ms": 10.667, "margin": 0.0,
        "buffer_size": 512, "fs": 48000, "pipeline_depth": 16,
        "saturated_reps": 11, "config_overrides": {},
        "wall_class": "deadline", "probes": [],
    }


def _confirm_rec(rows):
    return {
        "benchmark": "IIRFilter", "knob": "n_tracks", "kind": "confirm",
        "deadline_ms": 10.667, "buffer_size": 512, "fs": 48000,
        "pipeline_depth": 16, "saturated_reps": 101,
        "config_overrides": {},
        "confirms": [
            {"value": v, "sustains": ok, "saturated_p50_ms": p50,
             "saturated_p99_ms": p99}
            for v, ok, p50, p99 in rows
        ],
    }


def test_ledger_bracket_when_edge_fails():
    """Edge fails its n=101 confirm -> capacity = the certified point,
    bracket names the edge with its measured confirm."""
    bl = _load_tool("build_capacity_ledger")
    rec = bl.build(
        _search_rec(917504),
        _confirm_rec([(786432, True, 9.4, 9.6),
                      (917504, False, 10.65, 15.8)]),
    )
    assert rec["capacity"] == 786432
    assert rec["bracket"]["certified"] == 786432
    assert rec["bracket"]["edge"] == 917504
    assert "15.8" in rec["bracket"]["note"]
    assert rec["confirm_reps"] == 101
    assert rec["confirmation"]["value"] == 786432


def test_ledger_no_bracket_when_edge_sustains():
    bl = _load_tool("build_capacity_ledger")
    rec = bl.build(
        _search_rec(917504),
        _confirm_rec([(786432, True, 9.4, 9.6),
                      (917504, True, 10.4, 10.6)]),
    )
    assert rec["capacity"] == 917504
    assert "bracket" not in rec


def test_ledger_confirm_only_family():
    """Standing rows without a search JSON: '-' synthesizes the
    envelope from the confirm record."""
    bl = _load_tool("build_capacity_ledger")
    rec = bl.build(None, _confirm_rec([(32768, True, 4.3, 4.4)]))
    assert rec["capacity"] == 32768
    assert rec["buffer_size"] == 512
    assert "bracket" not in rec


def test_ledger_renders_bracket_in_table():
    bl = _load_tool("build_capacity_ledger")
    cap_mod = _load_tool("capacity")
    rec = bl.build(
        _search_rec(917504),
        _confirm_rec([(786432, True, 9.4, 9.6),
                      (917504, False, 10.65, 15.8)]),
    )
    md = cap_mod.render_md([rec])
    assert "786432 (edge 917504)" in md
    assert "confirm n=101" in md
