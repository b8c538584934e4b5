"""`python -m gpuaudiobench_jax.webui` entry point."""

from gpuaudiobench_jax.webui.server import main

raise SystemExit(main())
