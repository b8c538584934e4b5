"""Interactive benchmark runner UI (the WebGPU app analog).

The reference ships a browser app (webgpu/index.html +
webgpu/js/app.js: benchmark cards, per-benchmark parameter forms with
preset persistence, category suite runs with a progress bar, hardware
info panel, histogram charts, dark mode). On a headless accelerator
host the equivalent is a local HTTP server wrapping the same harness
the CLI uses, plus a self-contained single-file front end (no CDN --
accelerator hosts commonly have zero egress).

    python -m gpuaudiobench_jax.webui --port 8800

Package layout:
  params.py -- declarative parameter schemas (ParameterBuilder analog,
               webgpu/js/core/ParameterBuilder.js) mapped onto real
               BenchConfig fields.
  server.py -- stdlib ThreadingHTTPServer + JSON API + one worker
               thread that serializes device access.
  static/index.html -- the front end.
"""

from gpuaudiobench_jax.webui.params import (  # noqa: F401
    apply_params,
    benchmark_params,
    global_params,
)
