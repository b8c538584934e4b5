from gpuaudiobench_jax.parallel.mesh import make_mesh  # noqa: F401
from gpuaudiobench_jax.parallel.multichip import (  # noqa: F401
    make_suite_step,
    suite_step_example_args,
)
