"""The port's native GPMF walker (``routeformer_torch/io/gpmf_native.py``
over its copy of ``csrc/gpmf.cpp``) against the port's Python walker and
the JAX package's native walker on the CPU: the same points (latitude,
longitude, altitude, speed and timestamp) and dilutions, exactly, on the
fixture's streams, on streams cut short and on mutated bytes; where the
walker calls a stream non-canonical, both packages say so and the Python
walker takes it."""

import datetime
import struct

import numpy as np
import pytest

from routeformer_torch.io import gpmf, gpmf_native, native
from routeformer_torch.io.gem_fixture import gpmf_stream, make_trajectory
from routeformer_tpu.io import gpmf_native as jax_native


def _stream(seconds=20.0, seed=0, start=1_630_000_000.0):
    return gpmf_stream(make_trajectory(seconds, seed=seed, turn=1.0), start)


def _batched_stream():
    """50 one-second GPS5 batches with a GPSU stamp each, the dilution
    above the threshold in every fifth batch."""
    items = [("SCAL", "l", struct.pack(">lllll", 10000000, 10000000, 1000, 1000, 100), 4, 5),
             ("GPSF", "L", struct.pack(">L", 3), 4, 1)]
    base = datetime.datetime(2023, 5, 15, 12, 0, 0)
    for batch in range(50):
        t = base + datetime.timedelta(seconds=batch, microseconds=1000 * (batch % 7))
        items.append(("GPSP", "S", struct.pack(">H", 700 if batch % 5 == 0 else 120), 2, 1))
        items.append(("GPSU", "U", t.strftime("%y%m%d%H%M%S.%f")[:16].encode(), 16, 1))
        rows = b"".join(struct.pack(">lllll", int((47.0 + batch * 1e-4 + i * 1e-6) * 1e7),
                                    80000000, 400000, 5000, 500) for i in range(18))
        items.append(("GPS5", "l", rows, 20, 18))
    return gpmf.encode_gpmf(items)


def _key(points):
    return [(p.latitude, p.longitude, p.altitude, p.speed, p.time) for p in points]


STREAMS = {"fixture": _stream(), "fixture-long": _stream(62.0, seed=3),
           "batched": _batched_stream()}


@pytest.mark.parametrize("name", list(STREAMS))
def test_native_walker_matches_python_and_jax(name):
    data = STREAMS[name]
    got = gpmf_native.build_gps_points_native(data, 500.0)
    want = gpmf.build_gps_points(data, 500.0, prefer_native=False)
    ref = jax_native.build_gps_points_native(data, 500.0)
    assert got is not None and ref is not None and len(got[0]) > 0
    assert _key(got[0]) == _key(want[0]) == _key(ref[0])
    assert got[1] == want[1] == ref[1]
    assert _key(gpmf.build_gps_points(data)[0]) == _key(want[0])  # the default: native


@pytest.mark.parametrize("name", list(STREAMS))
def test_truncated_and_mutated_payloads(name):
    """Every cut of the stream (every 37th byte) and 60 mutated copies:
    where the port's walker returns points, they are the Python walker's;
    it calls a stream non-canonical exactly where JAX's walker does."""
    stream = STREAMS[name]
    rng = np.random.default_rng(len(stream))
    corpus = [stream[:cut] for cut in range(0, len(stream), 37)]
    for _ in range(60):
        blob = bytearray(stream)
        for _ in range(int(rng.integers(1, 12))):
            blob[int(rng.integers(0, len(blob)))] = int(rng.integers(0, 256))
        corpus.append(bytes(blob))
    handled = 0
    for blob in corpus:
        got = gpmf_native.build_gps_points_native(blob, 500.0)
        ref = jax_native.build_gps_points_native(blob, 500.0)
        assert (got is None) == (ref is None)
        if got is None:
            continue
        handled += 1
        want = gpmf.build_gps_points(blob, 500.0, prefer_native=False)
        assert _key(got[0]) == _key(want[0]) == _key(ref[0])
        assert got[1] == want[1]
    assert handled >= len(corpus) // 2


def test_a_walker_that_cannot_build_raises(tmp_path, monkeypatch):
    """No g++: ``build_gps_points`` raises ImportError naming the library,
    not a quiet switch to Python; ``prefer_native=False`` asks for the
    Python walker."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda _: None)
    with pytest.raises(ImportError, match="libgpmf: g\\+\\+ not found"):
        gpmf.build_gps_points(STREAMS["fixture"])
    assert len(gpmf.build_gps_points(STREAMS["fixture"], prefer_native=False)[0]) > 0


@pytest.mark.parametrize("name", list(STREAMS))
def test_gps_arrays_match_jax(name):
    """``build_gps_arrays`` (values, fixed stamps, dilutions) and
    ``fix_timestamps_array`` on the walker's raw stamps, exactly JAX's."""
    data = STREAMS[name]
    got, want = gpmf_native.build_gps_arrays(data, 500.0), jax_native.build_gps_arrays(data, 500.0)
    assert got is not None and want is not None and len(got[0]) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    _, times = gpmf_native.extract_gps_raw(data)
    np.testing.assert_array_equal(gpmf_native.fix_timestamps_array(times),
                                  jax_native.fix_timestamps_array(times))


def test_fix_timestamps_array_matches_jax_on_gaps():
    """NaN gaps, a missing head, implausible rates (dropped stamps) and an
    all-NaN track."""
    rng = np.random.default_rng(5)
    times = 1_630_000_000.0 + np.arange(200) / 18.17
    times[rng.random(200) < 0.6] = np.nan
    times[:7] = np.nan
    times[50] += 0.4  # an implausible rate around it
    for t in (times, np.full(9, np.nan), times[:1], np.empty(0)):
        np.testing.assert_array_equal(gpmf_native.fix_timestamps_array(t),
                                      jax_native.fix_timestamps_array(t))


def test_native_available_reports_the_build(tmp_path, monkeypatch):
    assert gpmf_native.native_available() is True
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda _: None)
    monkeypatch.setattr(native, "_libs", {})
    assert gpmf_native.native_available() is False
    with pytest.raises(ImportError, match="libgpmf"):
        gpmf_native.build_gps_arrays(STREAMS["fixture"])
