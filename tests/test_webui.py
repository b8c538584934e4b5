"""End-to-end tests for the interactive runner (webui/).

The WebGPU app analog (webgpu/js/app.js): benchmark catalog with
parameter schemas, hardware panel, queued suite runs with progress,
preset persistence, session export. Exercised over real HTTP against
the stdlib server on an ephemeral port, runs executed on the virtual
CPU mesh.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from gpuaudiobench_jax.config import BenchConfig
from gpuaudiobench_jax.registry import list_benchmarks
from gpuaudiobench_jax.webui.params import (
    apply_params,
    benchmark_params,
    global_params,
)
from gpuaudiobench_jax.webui.server import serve


# ---------------------------------------------------------------------------
# params.py unit tests
# ---------------------------------------------------------------------------


def test_global_params_defaults_roundtrip():
    cfg = BenchConfig()
    schema = global_params()
    ids = {p["id"] for p in schema}
    assert {"bufferSize", "nTracks", "nRuns", "warmup",
            "verification", "pipelineDepth"} <= ids
    assert "impl" not in ids  # one implementation per workload
    # Applying every default reproduces the default config fields.
    defaults = {p["id"]: p["default"] for p in schema}
    out = apply_params(cfg, defaults)
    assert out.buffer_size == cfg.buffer_size
    assert out.n_tracks == cfg.n_tracks
    assert out.verification == cfg.verification


def test_every_benchmark_schema_applies():
    cfg = BenchConfig()
    for name in list_benchmarks():
        schema = benchmark_params(name)
        defaults = {p["id"]: p["default"] for p in schema}
        out = apply_params(cfg, defaults)
        out.validate()


def test_apply_params_rejects_unknown_and_invalid():
    cfg = BenchConfig()
    with pytest.raises(ValueError):
        apply_params(cfg, {"nope": 1})
    with pytest.raises(ValueError):
        apply_params(cfg, {"bufferSize": "abc"})
    with pytest.raises(ValueError):
        apply_params(cfg, {"verification": "bogus"})


def test_apply_params_modal_zero_is_auto():
    out = apply_params(BenchConfig(), {"modalModes": 0})
    assert out.modal_num_modes is None
    out = apply_params(BenchConfig(), {"modalModes": 4096})
    assert out.modal_num_modes == 4096


def test_apply_params_bool_coercion():
    out = apply_params(BenchConfig(), {"dawsim": "true",
                                       "fdtdPerTrackReceivers": True})
    assert out.dawsim is True
    assert out.fdtd_per_track_receivers is True


# ---------------------------------------------------------------------------
# HTTP server end-to-end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ui_server(tmp_path_factory):
    presets = tmp_path_factory.mktemp("webui") / "presets.json"
    httpd = serve(port=0, presets_path=str(presets))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    yield base
    httpd.shutdown()
    httpd.job_runner.shutdown()


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        ctype = r.headers.get("Content-Type", "")
        body = r.read()
    return ctype, body


def _get_json(base, path):
    ctype, body = _get(base, path)
    assert "json" in ctype
    return json.loads(body)


def _post_json(base, path, obj, expect_ok=True):
    req = urllib.request.Request(
        base + path, data=json.dumps(obj).encode(), method="POST",
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        if expect_ok:
            raise
        return e.code, json.loads(e.read())


def test_index_served(ui_server):
    ctype, body = _get(ui_server, "/")
    assert "text/html" in ctype
    assert b"Audio Benchmarks" in body
    assert b"src=\"http" not in body and b"href=\"http" not in body  # zero egress


def test_hardware_endpoint(ui_server):
    hw = _get_json(ui_server, "/api/hardware")
    assert hw["platform"] == "cpu"  # conftest forces the virtual mesh
    assert hw["num_devices"] == 8
    assert "jax_version" in hw


def test_benchmarks_catalog(ui_server):
    cat = _get_json(ui_server, "/api/benchmarks")
    names = [b["name"] for b in cat["benchmarks"]]
    assert names == list_benchmarks()
    assert "dsp" in cat["categories"]
    conv = next(b for b in cat["benchmarks"] if b["name"] == "Conv1D")
    assert any(p["id"] == "irLength" for p in conv["params"])
    assert any(p["id"] == "bufferSize" for p in cat["global_params"])


def _wait_job(base, job_id, timeout=300.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        job = _get_json(base, f"/api/job?id={job_id}")
        if job["status"] in ("done", "error"):
            return job
        time.sleep(0.3)
    raise TimeoutError("job did not finish")


SMALL = {
    "bufferSize": 64,
    "nTracks": 8,
    "nRuns": 3,
    "warmup": 1,
    "deviceTiming": False,
}


def test_run_single_benchmark(ui_server):
    code, resp = _post_json(
        ui_server, "/api/run", {"benchmarks": ["gain"], "params": SMALL}
    )
    assert code == 202
    job = _wait_job(ui_server, resp["job_id"])
    assert job["status"] == "done"
    assert job["errors"] == []
    (res,) = job["results"]
    assert res["benchmark"] == "gain"
    assert res["validation"]["status"] == "SUCCESS"
    assert res["statistics"]["p50_ms"] > 0
    assert len(res["raw_latencies_ms"]) == 3


def test_run_with_benchmark_params(ui_server):
    params = dict(SMALL, irLength=128, convEdgeMode="clamp")
    code, resp = _post_json(
        ui_server, "/api/run", {"benchmarks": ["Conv1D"], "params": params}
    )
    job = _wait_job(ui_server, resp["job_id"])
    assert job["status"] == "done", job["errors"]
    assert job["results"][0]["validation"]["status"] == "SUCCESS"
    assert job["results"][0]["metadata"]["irLength"] == 128


def test_run_category_suite_with_progress(ui_server):
    code, resp = _post_json(
        ui_server, "/api/run", {"category": "basic", "params": SMALL}
    )
    job = _wait_job(ui_server, resp["job_id"])
    assert job["status"] == "done"
    assert job["total"] == 3 and job["completed"] == 3
    assert {r["benchmark"] for r in job["results"]} == {
        "NoOp", "gain", "GainStats"
    }


def test_run_rejects_bad_requests(ui_server):
    code, resp = _post_json(ui_server, "/api/run", {}, expect_ok=False)
    assert code == 400
    code, resp = _post_json(
        ui_server, "/api/run", {"benchmarks": ["NotABenchmark"]},
        expect_ok=False,
    )
    assert code == 400 and "NotABenchmark" in resp["error"]
    code, resp = _post_json(
        ui_server, "/api/run",
        {"benchmarks": ["gain"], "params": {"bogusParam": 1}},
        expect_ok=False,
    )
    assert code == 400 and "bogusParam" in resp["error"]
    code, resp = _post_json(
        ui_server, "/api/run", {"category": "nope"}, expect_ok=False
    )
    assert code == 400


def test_suite_resilience_partial_failure(ui_server):
    # MultiChipSuite with an oversized mesh fails; gain still completes.
    params = dict(SMALL, mesh="64,1,1")
    code, resp = _post_json(
        ui_server, "/api/run",
        {"benchmarks": ["MultiChipSuite", "gain"], "params": params},
    )
    job = _wait_job(ui_server, resp["job_id"])
    assert job["status"] == "done"
    assert len(job["errors"]) == 1 and "MultiChipSuite" in job["errors"][0]
    assert [r["benchmark"] for r in job["results"]] == ["gain"]


def test_presets_roundtrip(ui_server):
    _post_json(
        ui_server, "/api/presets",
        {"benchmark": "Conv1D", "name": "long-ir",
         "params": {"irLength": 2048}},
    )
    presets = _get_json(ui_server, "/api/presets")
    assert presets["Conv1D"]["long-ir"]["irLength"] == 2048
    code, resp = _post_json(
        ui_server, "/api/presets",
        {"action": "delete", "benchmark": "Conv1D", "name": "long-ir"},
    )
    assert resp["ok"] is True
    assert "Conv1D" not in _get_json(ui_server, "/api/presets")


def test_session_export(ui_server):
    # Earlier run tests populated the session accumulator.
    data = _get_json(ui_server, "/api/export.json")
    assert any(r["benchmark"] == "gain" for r in data["results"])
    ctype, body = _get(ui_server, "/api/export.csv")
    assert "csv" in ctype
    lines = body.decode().strip().splitlines()
    assert lines[0].startswith("benchmark,fs,bufferSize")
    assert len(lines) >= 2


def test_unknown_routes_404(ui_server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(ui_server, "/api/nope")
    assert e.value.code == 404


def test_compare_endpoint(ui_server):
    data = _get_json(ui_server, "/api/compare")
    assert "ModalFilterBank" in data["published"]
    assert data["published"]["ModalFilterBank"]["PC"][0] == 3.168
    assert "1048576" in data["modal_sweep"] or 1048576 in {
        int(k) for k in data["modal_sweep"]
    }


def test_index_html_ids_consistent():
    """Every element id the embedded JS looks up must exist in the HTML
    (no browser in CI, so this static check stands in for a DOM test)."""
    import os
    import re

    from gpuaudiobench_jax.webui import server as srv

    html = open(os.path.join(srv.STATIC_DIR, "index.html")).read()
    script = re.search(r"<script>(.*)</script>", html, re.S).group(1)
    looked_up = set(re.findall(r'\$\("([\w-]+)"\)', script))
    looked_up |= set(re.findall(r'getElementById\("([\w-]+)"\)', script))
    declared = set(re.findall(r'id="([\w-]+)"', html))
    # ids built dynamically at runtime (chart containers) are exempt
    missing = {i for i in looked_up if i not in declared
               and not i.startswith("chart-")}
    assert not missing, f"JS references undeclared ids: {sorted(missing)}"


def test_index_html_brace_balance():
    """Structural check of the embedded JS: brackets balance once
    strings/templates are stripped (a syntax error would kill the whole
    UI and no JS engine exists in CI to catch it)."""
    import os
    import re

    from gpuaudiobench_jax.webui import server as srv

    html = open(os.path.join(srv.STATIC_DIR, "index.html")).read()
    js = re.search(r"<script>(.*)</script>", html, re.S).group(1)
    js = re.sub(r"//[^\n]*", "", re.sub(r"/\*.*?\*/", "", js, flags=re.S))

    out = []
    mode_stack = ["code"]
    tmpl_expr_depth = []
    brace_depth = 0
    i, n = 0, len(js)
    while i < n:
        c = js[i]
        if mode_stack[-1] == "code":
            if c in "\"'":
                q = c
                i += 1
                while i < n:
                    if js[i] == "\\":
                        i += 2
                        continue
                    if js[i] == q:
                        i += 1
                        break
                    i += 1
                continue
            if c == "`":
                mode_stack.append("tmpl")
                i += 1
                continue
            if c == "{":
                brace_depth += 1
            if c == "}":
                if tmpl_expr_depth and brace_depth == tmpl_expr_depth[-1]:
                    tmpl_expr_depth.pop()
                    mode_stack.pop()
                    out.append(")")
                    i += 1
                    continue
                brace_depth -= 1
            out.append(c)
            i += 1
        else:  # template text
            if c == "\\":
                i += 2
                continue
            if c == "`":
                mode_stack.pop()
                i += 1
                continue
            if c == "$" and i + 1 < n and js[i + 1] == "{":
                mode_stack.append("code")
                tmpl_expr_depth.append(brace_depth)
                out.append("(")
                i += 2
                continue
            i += 1
    pairs = {")": "(", "]": "[", "}": "{"}
    stack = []
    for ch in "".join(out):
        if ch in "([{":
            stack.append(ch)
        elif ch in ")]}":
            assert stack and stack[-1] == pairs[ch], "bracket mismatch"
            stack.pop()
    assert not stack, f"unclosed brackets: {stack[-5:]}"
    assert not mode_stack[1:], "unterminated string/template"


def test_jobs_queue_serially(ui_server):
    """Two jobs submitted back-to-back both complete; the device worker
    is a single thread so they never overlap (the listing shows both)."""
    codes = []
    ids = []
    for _ in range(2):
        code, resp = _post_json(
            ui_server, "/api/run", {"benchmarks": ["NoOp"], "params": SMALL}
        )
        codes.append(code)
        ids.append(resp["job_id"])
    assert codes == [202, 202]
    jobs = [_wait_job(ui_server, i) for i in ids]
    assert all(j["status"] == "done" and not j["errors"] for j in jobs)
    listing = _get_json(ui_server, "/api/jobs")["jobs"]
    assert {j["id"] for j in jobs} <= {j["id"] for j in listing}


def test_suite_run_applies_benchmark_overrides(ui_server):
    """Suite runs layer each benchmark's form overrides over the global
    params (they used to be silently dropped)."""
    code, resp = _post_json(
        ui_server, "/api/run",
        {"benchmarks": ["Conv1D", "gain"], "params": SMALL,
         "benchmark_params": {"Conv1D": {"irLength": 192}}},
    )
    assert code == 202
    job = _wait_job(ui_server, resp["job_id"])
    assert job["status"] == "done", job["errors"]
    conv = next(r for r in job["results"] if r["benchmark"] == "Conv1D")
    assert conv["metadata"]["irLength"] == 192
    # bad per-benchmark params fail fast at submit
    code, resp = _post_json(
        ui_server, "/api/run",
        {"benchmarks": ["Conv1D"], "params": SMALL,
         "benchmark_params": {"Conv1D": {"nope": 1}}},
        expect_ok=False,
    )
    assert code == 400


def test_post_cross_origin_guard(ui_server):
    """State-changing POSTs require application/json (forcing a CORS
    preflight for cross-origin callers) and a loopback/bound Host
    (blocking DNS rebinding) -- ADVICE r2 hardening."""
    # Simple content type (what a no-preflight cross-origin POST can
    # send) is rejected before any parsing.
    req = urllib.request.Request(
        ui_server + "/api/run",
        data=json.dumps({"benchmarks": ["NoOp"]}).encode(),
        method="POST", headers={"Content-Type": "text/plain"},
    )
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    assert ei.value.code == 415
    # A foreign Host header (DNS rebinding: attacker.example resolves
    # to 127.0.0.1) is rejected even with the right content type.
    req = urllib.request.Request(
        ui_server + "/api/presets",
        data=json.dumps({"benchmark": "gain", "name": "x"}).encode(),
        method="POST",
        headers={"Content-Type": "application/json",
                 "Host": "attacker.example"},
    )
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    assert ei.value.code == 403
    # GETs (read-only) are unaffected.
    assert _get_json(ui_server, "/api/jobs") is not None


def test_job_reports_phase(ui_server):
    """Job status carries the runner's stage-boundary phase (r3: the
    device-timing pass can take minutes; the UI shows which stage is
    running instead of an opaque 'running')."""
    code, resp = _post_json(
        ui_server, "/api/run",
        {"benchmarks": ["gain"], "params": dict(SMALL, nRuns=1000)},
    )
    assert code == 202
    phases = set()
    deadline = time.time() + 300
    while time.time() < deadline:
        job = _get_json(ui_server, f"/api/job?id={resp['job_id']}")
        if job.get("phase"):
            phases.add(job["phase"])
        if job["status"] in ("done", "error"):
            break
        time.sleep(0.02)
    assert job["status"] == "done"
    assert job["phase"] is None  # cleared at completion
    # At least one mid-run phase observed (tiny runs may blow through
    # some stages between polls; "timed"/"validate" are the long ones
    # at nRuns=1000 on CPU).
    assert phases, "no phase ever surfaced"
    assert phases <= {"setup", "warmup", "timed", "device-timing",
                      "saturated", "validate"}


def test_running_job_reports_stall():
    """A running job whose phase hasn't advanced for STALL_AFTER_S is
    reported with stalled_seconds -- a wedged device call cannot be
    interrupted from Python, so the API must at least say so instead
    of looking identical to healthy progress."""
    import time as _time

    from gpuaudiobench_jax.webui.server import JobRunner

    r = JobRunner()
    try:
        # Hand-install a running job frozen in the past; nothing is
        # queued, so the worker never touches it.
        with r._lock:
            r.jobs["stuck1"] = {
                "id": "stuck1", "status": "running",
                "benchmarks": ["gain"], "completed": 0, "total": 1,
                "current": "gain", "phase": "device-timing",
                "results": [], "errors": [],
                "submitted_at": _time.time() - 1000,
                "phase_at": _time.time() - 1000,
            }
        job = r.get("stuck1")
        assert job["stalled_seconds"] >= 900
        # the jobs LISTING must tell the same story as the job view
        listed = {j["id"]: j for j in r.list_jobs()}
        assert listed["stuck1"]["stalled_seconds"] >= 900
        # fresh progress -> no stall flag
        with r._lock:
            r.jobs["stuck1"]["phase_at"] = _time.time()
        assert "stalled_seconds" not in r.get("stuck1")
        # finished jobs never report stall regardless of age
        with r._lock:
            r.jobs["stuck1"]["status"] = "done"
            r.jobs["stuck1"]["phase_at"] = _time.time() - 1000
        assert "stalled_seconds" not in r.get("stuck1")
    finally:
        r.shutdown()
