from gpuaudiobench_jax.utils.data import (  # noqa: F401
    biquad_lowpass_coefficients,
    conv1d_impulse_responses,
    generate_impulse_response,
    generate_random_audio,
    generate_test_pattern,
    generate_uniform01,
)
