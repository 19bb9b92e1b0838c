"""The port's native decode tier (video_quierer_tpu_torch/ingest/native.py
over native/decoder.cpp, ``extract_frames(use_native=...)``,
``VQT_NATIVE_DECODE=1``) on synthetic mp4s written with OpenCV.

- The library is built by the port's loader into ``build/native/`` inside
  a fixture (never at import or collection); the tests skip only where a
  C++ compiler, ``pkg-config`` or the libav development files are
  missing.
- The JAX package's binding runs on the port's build: its ``_LIB_PATH``
  points there (monkeypatched, with ``_lib`` and ``_load_attempted``
  reset), so its loader finds the file and runs no ``make``.
- Probe and decode equal the JAX binding's bit for bit; against the
  OpenCV path, the same timestamps and a mean absolute pixel difference
  below 10 a frame (JAX ``tests/test_native_decoder.py:37-50``).
"""

import logging
import threading

import numpy as np
import pytest

from tests.helpers import make_synthetic_video
from video_quierer_tpu.ingest import frames as jax_frames
from video_quierer_tpu.ingest import native as jax_native
from video_quierer_tpu_torch.ingest import frames
from video_quierer_tpu_torch.ingest import native
from video_quierer_tpu_torch.ingest import pipeline


@pytest.fixture(scope="module")
def lib():
    if not native.toolchain_available():
        pytest.skip("no C++ compiler, pkg-config or libav development "
                    "files")
    return native.build()


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    d = tmp_path_factory.mktemp("native")
    return make_synthetic_video(d / "nat.mp4", n_frames=120, fps=30.0,
                                size=(128, 96))


@pytest.fixture
def jax_binding(lib, monkeypatch):
    """The JAX package's binding over the port's build (no ``make``)."""
    monkeypatch.setattr(jax_native, "_LIB_PATH", lib)
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_load_attempted", False)
    assert jax_native.available()
    return jax_native


def test_build_lands_in_build_native(lib):
    assert lib.parent == native.BUILD_DIR
    assert lib.parent.parts[-2:] == ("build", "native")
    assert lib.exists() and native.lib_path() == lib
    assert native.available()


def test_probe_matches_jax_and_opencv(lib, video, jax_binding):
    got = native.probe(video)
    assert got == jax_binding.probe(video)
    fps, total, w, h = got
    meta = frames.probe_video(video)
    assert abs(fps - meta.fps) < 0.01 and total == meta.total_frames
    assert (w, h) == (128, 96)


def test_probe_and_decode_refuse_bad_files(lib, tmp_path):
    assert native.probe(tmp_path / "missing.mp4") is None
    bad = tmp_path / "bad.mp4"
    bad.write_bytes(b"garbage")
    assert native.decode_sampled(bad, 1, 5) is None


@pytest.mark.parametrize("interval,max_frames,size",
                         [(1, 5, 224), (7, 12, 224), (30, 10, 64)])
def test_decode_sampled_matches_jax_binding(lib, video, jax_binding,
                                            interval, max_frames, size):
    got = native.decode_sampled(video, interval, max_frames, size)
    want = jax_binding.decode_sampled(video, interval, max_frames, size)
    assert got[0].shape == (min(max_frames, -(-120 // interval)), size,
                            size, 3)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_allclose(got[1][:3], [i * interval / 30.0
                                            for i in range(3)])


@pytest.mark.parametrize("mode", frames.SAMPLING_MODES)
def test_extract_frames_native_matches_jax_and_opencv(lib, video,
                                                      jax_binding, mode):
    nat, nat_ts = frames.extract_frames(video, max_frames=12,
                                        sampling_mode=mode, use_native=True)
    jnat, jnat_ts = jax_frames.extract_frames(
        video, max_frames=12, sampling_mode=mode, use_native=True)
    np.testing.assert_array_equal(nat, jnat)
    assert nat_ts == jnat_ts
    cv, cv_ts = frames.extract_frames(video, max_frames=12,
                                      sampling_mode=mode, use_native=False)
    assert nat.shape == cv.shape
    np.testing.assert_allclose(nat_ts, cv_ts)
    for i in range(nat.shape[0]):
        diff = np.abs(nat[i].astype(np.int32) - cv[i].astype(np.int32))
        assert diff.mean() < 10.0, (i, diff.mean())


def test_env_toggle_takes_the_tier(lib, video, monkeypatch):
    calls = []
    real = native.decode_sampled
    monkeypatch.setattr(native, "decode_sampled",
                        lambda *a, **kw: calls.append(a) or real(*a, **kw))
    monkeypatch.setenv("VQT_NATIVE_DECODE", "1")
    f1, ts1 = frames.extract_frames(video, max_frames=5)
    assert len(calls) == 1
    # the ingest pipeline's extractor reaches the tier through it
    f2, ts2 = pipeline._interval_extract(video, 5, "high")
    assert len(calls) == 2
    np.testing.assert_array_equal(f1, f2)
    monkeypatch.delenv("VQT_NATIVE_DECODE")
    f3, ts3 = frames.extract_frames(video, max_frames=5)
    assert len(calls) == 2 and f3.shape == f1.shape
    np.testing.assert_allclose(ts1, ts3)


def test_unavailable_library_serves_the_opencv_path(video, monkeypatch,
                                                    caplog):
    """Where the library cannot be built, the tier logs it and the OpenCV
    path's frames come back."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_attempted", False)

    def no_build():
        raise native.NativeBuildError("no compiler")

    monkeypatch.setattr(native, "build", no_build)
    with caplog.at_level(logging.INFO, logger=native.__name__):
        got, ts = frames.extract_frames(video, max_frames=6,
                                        use_native=True)
    assert "using OpenCV path" in caplog.text
    want, want_ts = frames.extract_frames(video, max_frames=6,
                                          use_native=False)
    np.testing.assert_array_equal(got, want)
    assert ts == want_ts
    assert native.probe(video) is None


def test_parallel_builds_do_not_race(lib, tmp_path, monkeypatch):
    """Several build calls at once: one compile, one library, no
    temporary file left (the fcntl lock, then ``os.replace``)."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build" / "native")
    runs = []
    real_run = native.subprocess.run

    def counting_run(cmd, *a, **kw):
        if cmd[0] == native._cxx():
            runs.append(cmd)
        return real_run(cmd, *a, **kw)

    monkeypatch.setattr(native.subprocess, "run", counting_run)
    out, errors = [], []

    def build():
        try:
            out.append(native.build())
        except Exception as e:          # pragma: no cover - reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(set(out)) == 1 and len(runs) == 1
    files = sorted(p.name for p in native.BUILD_DIR.iterdir())
    assert files == [".lock", out[0].name]
