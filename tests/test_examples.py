"""The shipped examples must keep running: they are the user-facing
proof that the engine synthesizes audio, not only benchmark numbers."""

import os
import subprocess
import sys
import wave

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_streaming_synth_example(tmp_path):
    out = tmp_path / "bell.wav"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "examples/streaming_synth.py",
         "--seconds", "1", "--modes", "256", "--out", str(out)],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    # rc==0 already asserts the checkpoint/resume bit-equality the
    # example performs internally; also say so in the output.
    assert "checkpoint/resume bit-exact: True" in r.stdout
    with wave.open(str(out)) as w:
        assert w.getframerate() == 48_000
        assert w.getnchannels() == 1
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    assert len(pcm) >= 48_000 * 0.9  # ~1 s rendered
    rms = float(np.sqrt(np.mean((pcm / 32767.0) ** 2)))
    assert rms > 0.01, "rendered audio is silent"
    # the mid-render state checkpoint is left next to the wav
    assert (tmp_path / "bell.state.npz").exists()


def test_multichip_synth_example(tmp_path):
    out = tmp_path / "bell8.wav"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8").strip()
    r = subprocess.run(
        [sys.executable, "examples/multichip_synth.py",
         "--seconds", "0.5", "--modes", "512", "--out", str(out)],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "sharded over 8 device(s)" in r.stdout
    assert "matches single-device render: True" in r.stdout
    with wave.open(str(out)) as w:
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    assert float(np.sqrt(np.mean((pcm / 32767.0) ** 2))) > 0.01


def test_room_impulse_example(tmp_path):
    out = tmp_path / "rir.wav"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "examples/room_impulse.py",
         "--seconds", "0.2", "--out", str(out)],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "stable" in r.stdout and "UNSTABLE" not in r.stdout
    with wave.open(str(out)) as w:
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    # an impulse response must actually arrive and ring
    assert np.abs(pcm).max() > 1000


def test_reverb_example(tmp_path):
    out = tmp_path / "hall.wav"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "examples/reverb.py", "--seconds", "1",
         "--modes", "256", "--rt60", "0.25", "--out", str(out)],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    # rc==0 already asserts the stream==offline equality the example
    # performs internally (float32-rounding agreement with one f64
    # whole-take convolution).
    assert "streamed convolution matches offline: True" in r.stdout
    with wave.open(str(out)) as w:
        assert w.getframerate() == 48_000
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    assert float(np.sqrt(np.mean((pcm / 32767.0) ** 2))) > 0.01


def test_reverb_example_nupols(tmp_path):
    """The same stream==offline equality proof through the two-level
    Gardner form (rt60 chosen so the tail really exists: head =
    4 blocks * 512 = 2048 taps < 0.25 s * 48k)."""
    out = tmp_path / "hall_nu.wav"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "examples/reverb.py", "--seconds", "1",
         "--modes", "256", "--rt60", "0.25", "--form", "nupols",
         "--tail-chunk", "4", "--out", str(out)],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "streamed convolution matches offline: True" in r.stdout
    assert "nupols FDL" in r.stdout


def test_ampsim_example(tmp_path):
    out = tmp_path / "riff.wav"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "examples/ampsim.py", "--seconds", "1",
         "--layers", "6", "--out", str(out)],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    # rc==0 already asserts the streamed-with-carried-tails ==
    # one-shot-offline-inference equality the example performs.
    assert "streamed inference matches offline: True" in r.stdout
    with wave.open(str(out)) as w:
        assert w.getframerate() == 48_000
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    assert float(np.sqrt(np.mean((pcm / 32767.0) ** 2))) > 0.01


def test_session_example(tmp_path):
    out = tmp_path / "mix.wav"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "examples/session.py", "--seconds", "0.7",
         "--tracks", "4", "--modes", "128", "--rt60", "0.3",
         "--out", str(out)],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    # rc==0 already asserts the block-streamed session == one-shot
    # offline render equality the example performs internally.
    assert "streamed session matches offline: True" in r.stdout
    with wave.open(str(out)) as w:
        assert w.getframerate() == 48_000
        assert w.getnchannels() == 2
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    assert float(np.sqrt(np.mean((pcm / 32767.0) ** 2))) > 0.01
