"""Streaming-state checkpoint/resume (harness/checkpoint.py): a saved
carry restores bit-exactly against a fresh stream_body template, resumed
streams continue exactly where the original left off, and mismatched
checkpoints fail loudly."""

import numpy as np
import pytest

from gpuaudiobench_jax.harness.checkpoint import (
    load_stream_state,
    read_header,
    save_stream_state,
)
from gpuaudiobench_jax.registry import create_benchmark

STATEFUL = ["IIRFilter", "ModalFilterBank", "DWG1DNaive", "RndMemRead"]


def _stream(name, cfg):
    b = create_benchmark(name, cfg)
    b.setup()
    step, carry = b.stream_body()
    return step, carry


@pytest.mark.parametrize("name", STATEFUL)
def test_roundtrip_bit_exact(tmp_path, name, small_cfg):
    cfg = small_cfg.replace(n_tracks=8)
    step, carry = _stream(name, cfg)
    # evolve a few blocks so the carry is non-trivial
    for _ in range(3):
        carry, _ = step(carry)
    path = str(tmp_path / "state.npz")
    n = save_stream_state(path, carry, benchmark=name,
                          extra={"soak_seconds": 3})
    assert n >= 1
    hdr = read_header(path)
    assert hdr["benchmark"] == name
    assert hdr["extra"]["soak_seconds"] == 3

    # fresh template from a new benchmark instance
    step2, template = _stream(name, cfg)
    restored, _ = load_stream_state(path, template, benchmark=name)
    import jax

    for a, b in zip(jax.tree_util.tree_leaves(carry),
                    jax.tree_util.tree_leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # resumed stream continues identically to the uninterrupted one
    c_direct, out_direct = step(carry)
    c_resumed, out_resumed = step2(restored)
    np.testing.assert_array_equal(
        np.asarray(out_direct), np.asarray(out_resumed)
    )


def test_benchmark_mismatch_rejected(tmp_path, small_cfg):
    cfg = small_cfg.replace(n_tracks=8)
    _, carry = _stream("IIRFilter", cfg)
    path = str(tmp_path / "state.npz")
    save_stream_state(path, carry, benchmark="IIRFilter")
    _, template = _stream("IIRFilter", cfg)
    with pytest.raises(ValueError, match="benchmark"):
        load_stream_state(path, template, benchmark="ModalFilterBank")


def test_shape_mismatch_rejected(tmp_path, small_cfg):
    cfg = small_cfg.replace(n_tracks=8)
    _, carry = _stream("IIRFilter", cfg)
    path = str(tmp_path / "state.npz")
    save_stream_state(path, carry, benchmark="IIRFilter")
    _, template16 = _stream("IIRFilter", cfg.replace(n_tracks=16))
    with pytest.raises(ValueError, match="leaf"):
        load_stream_state(path, template16, benchmark="IIRFilter")


def test_not_a_checkpoint_rejected(tmp_path):
    path = str(tmp_path / "junk.npz")
    np.savez(path, header=np.frombuffer(b'{"format": "x"}', np.uint8))
    with pytest.raises(ValueError, match="format"):
        read_header(path)


def test_truncated_checkpoint_rejected(tmp_path, small_cfg):
    """A crash-truncated file surfaces as ValueError (not BadZipFile),
    and the atomic write means a failed save never truncates an
    existing checkpoint in place."""
    cfg = small_cfg.replace(n_tracks=8)
    _, carry = _stream("IIRFilter", cfg)
    path = str(tmp_path / "state.npz")
    save_stream_state(path, carry, benchmark="IIRFilter")
    good = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(good[: len(good) // 2])  # simulate torn write
    with pytest.raises(ValueError, match="unreadable"):
        read_header(path)
    # no stray temp file after a clean save (pid-unique tmp names)
    save_stream_state(path, carry, benchmark="IIRFilter")
    assert not list(tmp_path.glob("state.npz.tmp*"))


def test_lying_header_rejected(tmp_path, small_cfg):
    """A header whose n_leaves matches the template but whose arrays
    are missing fails with ValueError, not KeyError."""
    import json

    cfg = small_cfg.replace(n_tracks=8)
    _, carry = _stream("IIRFilter", cfg)
    import jax

    n = len(jax.tree_util.tree_leaves(carry))
    header = {"format": "audiobench-stream-state-v1",
              "benchmark": "IIRFilter", "n_leaves": n, "leaves": []}
    path = str(tmp_path / "lying.npz")
    np.savez(path, header=np.frombuffer(
        json.dumps(header).encode(), np.uint8))
    _, template = _stream("IIRFilter", cfg)
    with pytest.raises(ValueError, match="missing array"):
        load_stream_state(path, template, benchmark="IIRFilter")


def test_restore_preserves_device_placement(tmp_path, small_cfg):
    """Restored leaves are jax arrays carrying the template's
    sharding, so a resumed stream compiles against the same layout."""
    import jax

    cfg = small_cfg.replace(n_tracks=8)
    _, carry = _stream("ModalFilterBank", cfg)
    path = str(tmp_path / "state.npz")
    save_stream_state(path, carry, benchmark="ModalFilterBank")
    _, template = _stream("ModalFilterBank", cfg)
    restored, _ = load_stream_state(path, template,
                                    benchmark="ModalFilterBank")
    for t, r in zip(jax.tree_util.tree_leaves(template),
                    jax.tree_util.tree_leaves(restored)):
        if hasattr(t, "sharding"):
            assert hasattr(r, "sharding")
            assert r.sharding.is_equivalent_to(t.sharding, t.ndim)
