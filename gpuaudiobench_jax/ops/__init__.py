"""Device compute ops: jitted XLA programs and one Pallas GPU kernel.

Every op is a pure function over float32 arrays with static shapes,
jit-compiled once at benchmark setup (the cuFFT-plan / Metal-pipeline
analog). Each workload has one implementation on the GPU: XLA as
written, except the modal bank, whose Triton kernel
(``modal_triton.py``) beats the XLA scan at the bench shape and keeps
the XLA form (``modal.py``) as its reference.
"""
