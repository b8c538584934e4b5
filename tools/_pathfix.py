"""Shared sys.path bootstrap for runnable-by-path tools.

``python tools/<name>.py`` puts tools/ (not the repo root) at
sys.path[0]; importing this module (which lives next to every tool)
prepends the repo root so ``gpuaudiobench_jax`` resolves from any cwd.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
