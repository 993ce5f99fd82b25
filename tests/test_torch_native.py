"""The port's native CSV reader (``native/csv_reader.cc``, built with g++
into the package's ``_build/``) against the port's CSV codec
(`io.frames.csv_to_frame`) and the JAX package's native reader, on the CPU.

Held, on every input: the same `RawFrame` as `csv_to_frame` for the same
bytes — the same columns in order, dtypes (int64, float64 or ``U``), values
bit for bit (-0.0 and the sign of a NaN kept), missing masks, and a quoted
``""`` read as the empty string — or the same error. Inputs: the codec's
own output (`frame_to_csv`) of the seeded synthetic LendingClub frame and of
seeded random frames with adversarial cells, the RFC 4180 cases of
``tests/test_native.py`` where the codec defines them (blank lines and
ragged rows are errors there, as in the codec), and number spellings
against numpy's parse. The numeric columns of the synthetic table equal
the JAX package's ``native.read_csv`` (which reads every number as
float64). Without a toolchain ``engine="native"`` raises and ``"auto"``
logs one warning and reads with the codec; `ObjectStore.load_frame` reads
through the native reader.
"""

from __future__ import annotations

import logging
import shutil

import numpy as np
import pytest

from cobalt_smart_lender_ai_tpu import native as jax_native
from cobalt_smart_lender_ai_tpu_torch import native
from cobalt_smart_lender_ai_tpu_torch.data.frame import RawFrame
from cobalt_smart_lender_ai_tpu_torch.data.synthetic import synthetic_lendingclub_frame
from cobalt_smart_lender_ai_tpu_torch.io import ObjectStore
from cobalt_smart_lender_ai_tpu_torch.io.frames import csv_to_frame, frame_to_csv
from cobalt_smart_lender_ai_tpu_torch.ops import _build


def _assert_same(ref: RawFrame, got: RawFrame) -> None:
    assert got.columns == ref.columns
    assert got.n_rows == ref.n_rows
    for name in ref.columns:
        a, b = ref[name], got[name]
        if a.dtype.kind == "U":
            # Values and masks; the U width is the codec's own layout.
            assert b.dtype.kind == "U", name
            assert np.array_equal(ref.missing(name), got.missing(name)), name
            assert np.array_equal(a, b), name
        else:
            assert b.dtype == a.dtype, (name, a.dtype, b.dtype)
            assert np.array_equal(a.view(np.int64), b.view(np.int64)), name


def _both(data: bytes):
    """The codec's frame (or error) and the native reader's."""
    out = []
    for read in (csv_to_frame, lambda d: native.read_csv(d, engine="native")):
        try:
            out.append(read(data))
        except ValueError as exc:
            out.append(exc)
    return out


def _assert_reads_alike(data: bytes) -> RawFrame | None:
    ref, got = _both(data)
    if isinstance(ref, Exception):
        assert isinstance(got, ValueError), got
        assert str(got).startswith(str(ref))
        return None
    _assert_same(ref, got)
    return got


def test_builds_into_the_package_build_directory():
    assert native.native_available()
    path = native.library_path()
    assert path.exists() and path.parent == _build.BUILD_DIR
    assert path.parent.name == "_build" and path.parent.parent.name == "cobalt_smart_lender_ai_tpu_torch"
    assert path.name.startswith("csv_reader-") and path.suffix == ".so"


@pytest.mark.parametrize("n_rows,seed", [(2000, 3), (301, 0)])
def test_synthetic_table_reads_as_the_codec_reads_it(n_rows, seed):
    data = frame_to_csv(synthetic_lendingclub_frame(n_rows, seed))
    got = _assert_reads_alike(data)
    assert got.n_rows >= n_rows and len(got.columns) == 146


def test_numeric_columns_equal_the_jax_native_reader():
    data = frame_to_csv(synthetic_lendingclub_frame(2000, 3))
    got = native.read_csv(data, engine="native")
    ref = jax_native.read_csv(data, engine="native")
    assert got.columns == list(ref.columns)
    numeric = [n for n in got.columns if got[n].dtype.kind in "if"]
    assert len(numeric) > 100
    for name in numeric:
        a, b = ref[name].to_numpy(np.float64), got[name].astype(np.float64)
        assert np.array_equal(a.view(np.int64), b.view(np.int64)), name


NASTY = [
    "", "a,b", 'say "hi"', "line\nbreak", "NA", "null", "None", "nan", "0x1F",
    " padded ", "+5", "-", ".", "1e", "e5", "inf", "-inf", "'quote", "trail,",
    "日本語", "a" * 200, "cr\rin", '""', ",",
]


@pytest.mark.parametrize("seed", range(4))
def test_random_frames_read_as_the_codec_reads_them(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 200))
    cols, miss = {}, {}
    for j in range(int(rng.integers(1, 8))):
        kind = rng.integers(0, 4)
        if kind == 0:
            col = rng.normal(size=n) * 10.0 ** rng.integers(-5, 8)
            col[rng.random(n) < 0.3] = np.nan
            col[rng.random(n) < 0.1] = -0.0
            cols[f"num{j}"] = col
        elif kind == 1:
            cols[f"int{j}"] = rng.integers(-1000, 1000, n)
        elif kind == 2:
            cols[f"f32_{j}"] = rng.normal(size=n).astype(np.float32)
        else:
            cols[f"str{j}"] = np.array([NASTY[i] for i in rng.integers(len(NASTY), size=n)])
            miss[f"str{j}"] = rng.random(n) < 0.2
    _assert_reads_alike(frame_to_csv(RawFrame(cols, miss)))


RFC_CASES = {
    "quoted comma, escaped quote, empty last field": b'a,b c,d\n1,"hello, world",x\n2,"quote "" inside",\n',
    "newline inside quotes, CRLF line ends": b'a,b\r\n3,"multi\nline cell"\r\n4,y\r\n',
    "last row without newline, whitespace-only cell": b"a,b\n4e-2,  \n5,w",
    "quoted empty is the empty string": b'a\n""\n1\n',
    "blank line of a one-column table is a missing cell": b"a\n1\n\n2\n",
    "blank line of a wider table is an error": b"a,b\n1,x\n\n2,y\n",
    "short row is an error": b"a,b,c\n1,x\n",
    "long row is an error": b"a,b\n2,y,3\n",
    "header only": b"a,b\n",
    "empty input": b"",
    "quoted header": b'"x,1","y""z"\n1,2\n',
    "lone carriage return is data": b"a,b\nx\ry,1\n",
}


@pytest.mark.parametrize("case", list(RFC_CASES), ids=list(RFC_CASES))
def test_rfc4180_cases_read_as_the_codec_reads_them(case):
    _assert_reads_alike(RFC_CASES[case])


def test_inference_rules():
    """int64 when every field is an integer and none is missing; float64
    when every present field is a number; a string column otherwise; an
    empty column is float64 NaN; NA tokens are missing, quoted ones are
    strings."""
    csv = (b'i,f,mixed,empty,nan_token,quoted_na,ws\n'
           b'1,1.5,1,,nan,"NA",1\n'
           b'2,-2e3,x,,3,b,  \n')
    got = _assert_reads_alike(csv)
    assert got["i"].dtype == np.int64 and got["i"].tolist() == [1, 2]
    assert got["f"].dtype == np.float64
    assert got["mixed"].dtype.kind == "U" and got["mixed"].tolist() == ["1", "x"]
    assert got["empty"].dtype == np.float64 and np.isnan(got["empty"]).all()
    assert np.isnan(got["nan_token"][0]) and got["nan_token"][1] == 3.0
    assert got["quoted_na"].tolist() == ["NA", "b"] and not got.missing("quoted_na").any()
    assert got["ws"].dtype.kind == "U"  # a whitespace-only field is no number


NUMBERS = [
    "1", "+1", "-0", "00012", " 1", "1 ", "\t1", "1_000", "1__0", "_1", "1_", "1_.5",
    "1._5", "1e1_0", "1.5_5", "1e_5", ".5", "5.", ".", "+.5", "-.5e-3", "1e", "e5",
    "1e5.5", "1E5", "1e+5", "inf", "+inf", "-Infinity", "INF", "infinit", "+NAN",
    "-NAN", "nAn", "nan(1)", "0x10", "1d5", "1e400", "-1e400", "1e-400", "-1e-400",
    "4.9e-324", "2.2250738585072014e-308", "0.1", "123456789012345678901234567890",
    "9223372036854775807", "-9223372036854775808", "+-1", "--1",
]


@pytest.mark.parametrize("token", NUMBERS)
def test_number_spellings_read_as_numpy_reads_them(token):
    """One spelling in a column of integers: the column's kind and every
    value as the codec's numpy parse makes them."""
    got = _assert_reads_alike(f"x,y\n{token},1\n7,2\n".encode())
    if got is not None:
        want = np.array([token.encode()])
        try:
            value = want.astype(np.float64)[0]
        except ValueError:
            assert got["x"].dtype.kind == "U"
            return
        assert got["x"].dtype.kind in "if"
        if got["x"].dtype.kind == "f":
            assert np.float64(got["x"][0]).view(np.int64) == np.float64(value).view(np.int64)


@pytest.fixture
def no_toolchain(monkeypatch, tmp_path):
    """No library built yet and no g++ on the PATH."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_LIB_ERR", None)
    monkeypatch.setattr(shutil, "which", lambda name, *a, **k: None)


def test_native_engine_raises_without_a_toolchain(no_toolchain):
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.read_csv(b"a\n1\n", engine="native")
    with pytest.raises(RuntimeError):
        native.parse_csv_columns(b"a\n1\n")
    assert not native.native_available()


def test_auto_engine_logs_and_reads_with_the_codec_without_a_toolchain(no_toolchain, caplog):
    data = frame_to_csv(synthetic_lendingclub_frame(200, 1))
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        got = native.read_csv(data, engine="auto")
        native.read_csv(data, engine="auto")
    warnings = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warnings) == 1 and "csv_to_frame" in warnings[0].getMessage()
    _assert_same(csv_to_frame(data), got)


def test_engines_and_paths(tmp_path):
    data = b"a,s\n1,x\n2,\n"
    path = tmp_path / "t.csv"
    path.write_bytes(data)
    for engine in native.ENGINES:
        _assert_same(csv_to_frame(data), native.read_csv(path, engine=engine))
        _assert_same(csv_to_frame(data), native.read_csv(str(path), engine=engine))
    with pytest.raises(ValueError, match="unknown engine"):
        native.read_csv(data, engine="pandas")
    cols = native.parse_csv_columns(data)
    assert cols["a"].tolist() == [1, 2] and cols["s"].tolist() == ["x", ""]


def test_store_load_frame_reads_through_the_native_reader(tmp_path, monkeypatch):
    store = ObjectStore(str(tmp_path / "lake"))
    frame = synthetic_lendingclub_frame(300, 2)
    store.save_frame("t.csv", frame)
    want = csv_to_frame(store.get_bytes("t.csv"))

    def no_codec(data):
        raise AssertionError("load_frame fell back to the codec")

    monkeypatch.setattr(native, "csv_to_frame", no_codec)
    _assert_same(want, store.load_frame("t.csv"))
