"""The port's object store against the JAX package's, on the CPU.

- `write_pointer` writes the reference's ``.ptr.json`` byte for byte, and
  `verify_pointer` answers as the reference's; ``.npy``/``.npz`` objects
  are byte-equal; `exists`, `delete` and `list` agree.
- Frames as CSV, in both directions:
  - the port's CSV of ``synthetic_lendingclub_frame(2000)`` (146 columns:
    float64, int64 and string, with missing cells and empty strings) and of
    a frame of awkward strings (commas, quotes, line breaks, non-ASCII,
    missing cells, empty strings) and float32, float64 and int64 columns
    (NaN, -0.0, subnormals, 1e30) reads back in the port bit for bit, and
    reads in pandas (``float_precision="round_trip"``) and in the
    reference's native reader to the same values: numbers equal, strings
    equal, missing cells missing (an empty string reads as missing there,
    as those readers read the reference's own files);
  - a float32 column is written with float32 reprs, and a float64 column
    holding float32 values keeps its float64 digits;
  - the port reads the reference's ``save_frame`` output of the reference's
    synthetic frame to the values pandas reads;
  - `tokenize_raw_frame` of the port's ``load_frame`` of the stored raw
    table equals tokenizing the table itself.
"""

from __future__ import annotations

import io
from datetime import datetime

import numpy as np
import pandas as pd
import pytest

from cobalt_smart_lender_ai_tpu.data.synthetic import synthetic_lendingclub_frame as jax_synthetic
from cobalt_smart_lender_ai_tpu.io import ObjectStore as JaxStore
from cobalt_smart_lender_ai_tpu.native import native_available
from cobalt_smart_lender_ai_tpu.native import read_csv as jax_read_csv
from cobalt_smart_lender_ai_tpu_torch.data.device_pipeline import tokenize_raw_frame
from cobalt_smart_lender_ai_tpu_torch.data.frame import RawFrame
from cobalt_smart_lender_ai_tpu_torch.data.synthetic import synthetic_lendingclub_frame
from cobalt_smart_lender_ai_tpu_torch.io import PTR_SUFFIX, ObjectStore
from cobalt_smart_lender_ai_tpu_torch.io.frames import csv_to_frame, frame_to_csv

TODAY = datetime(2026, 8, 1)


def test_pointers_are_byte_equal_to_jax(tmp_path):
    port, ref = ObjectStore(str(tmp_path / "p")), JaxStore(str(tmp_path / "j"))
    for s in (port, ref):
        s.put_bytes("models/m.npz", b"\x00\x01payload" * 100)
    assert port.write_pointer("models/m.npz") == ref.write_pointer("models/m.npz")
    assert port.get_bytes("models/m.npz" + PTR_SUFFIX) == ref.get_bytes("models/m.npz" + PTR_SUFFIX)
    assert port.verify_pointer("models/m.npz") and ref.verify_pointer("models/m.npz")
    for s in (port, ref):
        s.put_bytes("models/m.npz", b"drifted")
    assert not port.verify_pointer("models/m.npz") and not ref.verify_pointer("models/m.npz")
    assert not port.verify_pointer("never/written") and not ref.verify_pointer("never/written")
    port.put_bytes("x" + PTR_SUFFIX, b"not json")
    port.put_bytes("x", b"x")
    assert not port.verify_pointer("x")


def test_arrays_and_listing_match_jax(tmp_path):
    port, ref = ObjectStore(str(tmp_path / "p")), JaxStore(str(tmp_path / "j"))
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    arrays = {"scores": a, "ids": np.arange(3)}
    for s in (port, ref):
        s.save_array("out/a.npy", a)
        s.save_arrays("out/b.npz", arrays)
        s.put_bytes("out/c/d.txt", b"d")
        s.put_bytes("other.txt", b"o")
    for key in ("out/a.npy", "out/b.npz"):
        assert port.get_bytes(key) == ref.get_bytes(key)
    assert np.array_equal(port.load_array("out/a.npy"), a)
    got = port.load_arrays("out/b.npz")
    assert set(got) == set(arrays) and all(np.array_equal(got[k], arrays[k]) for k in arrays)
    for prefix in ("", "out/", "out/c", "o", "none"):
        assert list(port.list(prefix)) == list(ref.list(prefix))
    assert port.exists("out/a.npy") and not port.exists("out")
    port.delete("out/c")
    port.delete("never/written")
    assert list(port.list("out/")) == ["out/a.npy", "out/b.npz"]


def _awkward_frame() -> RawFrame:
    n = 12
    strings = np.array(["plain", "a,b", 'say "hi"', "two\nlines", "cr\rhere", "", "naïve – ünïcode",
                        ",", '"', "  spaced  ", "x", "last"])
    miss = np.zeros(n, bool)
    miss[[4, 10]] = True
    f32 = np.array([0.1, -0.0, np.nan, 1e-30, 3.4e38, 1.4e-45, 16777217, -2.5, 0.3, 1 / 3, 7, 0],
                   dtype=np.float32)
    return RawFrame(
        {
            "text": strings,
            "f32": f32,
            "f64_of_f32": f32.astype(np.float64),
            "f64": np.array([0.1, 1 / 3, np.nan, -0.0, 1e300, 5e-324, 2**53, -1.5, 1e16, 123.456,
                             np.inf, 0.0]),
            "ints": np.arange(n, dtype=np.int64) * -7,
            "all_missing": np.full(n, np.nan),
            "odd name, quoted": np.ones(n),
        },
        {"text": miss},
    )


def _assert_same_frame(a: RawFrame, b: RawFrame) -> None:
    """Bit for bit: numbers by dtype and bits (float32 read back as
    float64 holding the same value), strings and their missing masks."""
    assert a.columns == b.columns
    for name in a.columns:
        x, y = a[name], b[name]
        if x.dtype.kind == "U":
            mx = a.missing(name) if a.missing(name) is not None else np.zeros(x.shape, bool)
            my = b.missing(name) if b.missing(name) is not None else np.zeros(y.shape, bool)
            assert y.dtype.kind == "U" and np.array_equal(mx, my), name
            assert np.array_equal(x[~mx], y[~my]), name
        else:
            want = np.float64 if x.dtype.kind == "f" else x.dtype
            assert y.dtype == want, (name, y.dtype)
            assert np.array_equal(x.view(np.uint8), y.astype(x.dtype).view(np.uint8)), name


def _assert_reader_values(frame: RawFrame, df: pd.DataFrame) -> None:
    """What pandas (or the native reader) read equals the frame: numbers
    equal in the frame's dtype, strings equal where present, missing where
    missing or empty."""
    assert list(df.columns) == frame.columns
    for name in frame.columns:
        x, col = frame[name], df[name]
        if x.dtype.kind == "U":
            m = frame.missing(name) if frame.missing(name) is not None else np.zeros(x.shape, bool)
            m = m | (x == "")
            assert np.array_equal(col.isna().to_numpy(), m), name
            assert np.array_equal(col[~m].astype(str).to_numpy(), x[~m]), name
        else:  # a float32 column reads as float64 that casts back to it
            got = col.to_numpy(np.float64).astype(x.dtype)
            assert np.array_equal(got, x, equal_nan=True), name
            assert np.array_equal(np.signbit(got), np.signbit(x)), name


@pytest.fixture(scope="module")
def frames():
    return {"synthetic": synthetic_lendingclub_frame(2000, seed=3), "awkward": _awkward_frame()}


@pytest.mark.parametrize("which", ["synthetic", "awkward"])
def test_port_csv_round_trips_bit_for_bit(frames, which, tmp_path):
    frame = frames[which]
    store = ObjectStore(str(tmp_path))
    store.save_frame("t.csv", frame)
    _assert_same_frame(frame, store.load_frame("t.csv"))
    assert store.get_bytes("t.csv") == frame_to_csv(frame)


@pytest.mark.parametrize("which", ["synthetic", "awkward"])
def test_pandas_reads_the_port_csv(frames, which):
    data = frame_to_csv(frames[which])
    _assert_reader_values(frames[which], pd.read_csv(io.BytesIO(data), float_precision="round_trip"))


@pytest.mark.skipif(not native_available(), reason="the reference's native reader needs g++")
@pytest.mark.parametrize("which", ["synthetic", "awkward"])
def test_native_reader_reads_the_port_csv(frames, which):
    data = frame_to_csv(frames[which])
    _assert_reader_values(frames[which], jax_read_csv(data, engine="native"))


def test_float_text_keeps_each_dtype_repr():
    f32 = np.array([0.1, 1 / 3, 1e-30, 16777217], dtype=np.float32)
    data = frame_to_csv(RawFrame({"a": f32, "b": f32.astype(np.float64)}))
    lines = data.decode().splitlines()
    assert lines[1] == "0.1,0.10000000149011612"
    assert lines[4] == "16777216.0,16777216.0"
    back = csv_to_frame(data)
    assert np.array_equal(back["a"].astype(np.float32), f32)
    assert np.array_equal(back["b"], f32.astype(np.float64))
    text = [line.split(",")[0] for line in lines[1:]]
    assert np.array_equal(np.array(text, dtype=np.float32), f32)  # float32 parse, not via float64


def test_port_reads_the_reference_save_frame(tmp_path):
    df = jax_synthetic(2000, seed=4)
    JaxStore(str(tmp_path)).save_frame("raw.csv", df)
    got = ObjectStore(str(tmp_path)).load_frame("raw.csv")
    want = pd.read_csv(io.BytesIO((tmp_path / "raw.csv").read_bytes()), float_precision="round_trip")
    assert got.columns == list(want.columns)
    for name in want.columns:
        col = want[name]
        if pd.api.types.is_numeric_dtype(col):
            assert got[name].dtype == col.dtype, name
            assert np.array_equal(got[name], col.to_numpy(), equal_nan=True), name
        else:
            m = col.isna().to_numpy()
            assert np.array_equal(got.missing(name), m), name
            assert np.array_equal(got[name][~m], col[~m].astype(str).to_numpy()), name


def test_tokenizing_the_stored_raw_table_equals_tokenizing_the_table(frames, tmp_path):
    frame = frames["synthetic"]
    store = ObjectStore(str(tmp_path))
    store.save_frame("dataset/1-raw/raw.csv", frame)
    a = tokenize_raw_frame(frame, today=TODAY)
    b = tokenize_raw_frame(store.load_frame("dataset/1-raw/raw.csv"), today=TODAY)
    assert a.columns == b.columns and a.kinds == b.kinds
    assert dict(a.vocab) == dict(b.vocab) and dict(a.missing_token) == dict(b.missing_token)
    assert np.array_equal(a.X, b.X, equal_nan=True)


def test_ragged_lines_are_refused():
    with pytest.raises(ValueError, match="fields"):
        csv_to_frame(b"a,b\n1,2\n3\n")
