"""The port's UI (``ui/core.py``, ``ui/app.py``) against the reference's.

The reference's ``tests/test_ui.py`` and ``tests/test_ui_smoke.py``, ported
to the port's asyncio server on the CPU (a small model fitted by the port on
the 20 serving features of a synthetic table), plus the same inputs through
both packages' pure functions:

- payloads equal for all five hardship options; waterfalls equal item by
  item; coerced columns equal to the reference's pandas frame (NaN where
  NaN); row payloads and importances equal;
- the waterfall's additivity on a live response, and its rendering;
- `ApiClient` over ``urllib``: 429 (retried, capped ``Retry-After``), 503
  ``circuit_open`` and 504 mapped to `ServiceDegraded` as the reference's
  client maps them against the same scripted server, other statuses raised,
  connection errors retried with the same backoff (injected sleep); a live
  admission cap gives ``reason="shed"``;
- ``ui.app.main()`` renders both modes under a stand-in ``streamlit``
  module (the reference's ``_FakeStreamlit``, whose ``dataframe`` counts the
  rows of the port's column mapping).
"""

from __future__ import annotations

import http.server
import json
import math
import sys
import threading
import types
import urllib.error

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402

from cobalt_smart_lender_ai_tpu.ui import core as ref_core  # noqa: E402
from cobalt_smart_lender_ai_tpu_torch.config import GBDTConfig, ReliabilityConfig, ServeConfig  # noqa: E402
from cobalt_smart_lender_ai_tpu_torch.data import (  # noqa: E402
    clean_raw_frame,
    engineer_features,
    prepare_cleaned_frame,
    schema,
    synthetic_lendingclub_frame,
)
from cobalt_smart_lender_ai_tpu_torch.data.features import drop_training_leakage  # noqa: E402
from cobalt_smart_lender_ai_tpu_torch.io import GBDTArtifact, ObjectStore  # noqa: E402
from cobalt_smart_lender_ai_tpu_torch.models.gbdt import GBDTClassifier  # noqa: E402
from cobalt_smart_lender_ai_tpu_torch.serve.http_asyncio import make_async_server  # noqa: E402
from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService, validate_single_input  # noqa: E402
from cobalt_smart_lender_ai_tpu_torch.ui import core  # noqa: E402


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(store, X): a 20-tree model on the serving contract, fitted by the
    port on the CPU, and the feature rows it was fitted on."""
    from datetime import datetime

    cleaned, _ = clean_raw_frame(synthetic_lendingclub_frame(2000, seed=5))
    tree_ff, _, _ = engineer_features(prepare_cleaned_frame(cleaned, today=datetime(2026, 8, 1)), device="cpu")
    ff = drop_training_leakage(tree_ff).select(schema.SERVING_FEATURES)
    X, y = ff.X.numpy(), ff.y.numpy()
    model = GBDTClassifier(GBDTConfig(n_estimators=20, max_depth=3, n_bins=32), device="cpu").fit(X, y)
    store = ObjectStore(str(tmp_path_factory.mktemp("ui") / "lake"))
    GBDTArtifact(forest=model.forest, feature_names=tuple(schema.SERVING_FEATURES),
                 bin_edges=model.bin_spec.edges.numpy()).save(store, "models/gbdt/model_tree")
    return store, X


@pytest.fixture(scope="module")
def live(served):
    store, X = served
    service = ScorerService.from_store(store, ServeConfig(), device="cpu")
    server = make_async_server(service, "127.0.0.1", 0)
    yield f"http://127.0.0.1:{server.port}", X
    server.close()
    service.close()


@pytest.fixture(scope="module")
def ui_env(live):
    return core.ApiClient(live[0])


def _form(hardship: str = "No_Hardship") -> tuple:
    numeric = {f: d for f, _, d in core.NUMERIC_INPUTS}
    return numeric, {"grade_E": True, "home_ownership_MORTGAGE": True}, hardship


def default_form_payload():
    return core.build_single_payload(*_form())


def _complete_rows(X, k: int) -> np.ndarray:
    """First ``k`` NaN-free rows: the explorer rebuilds a /predict body,
    whose contract cannot express a missing value."""
    Xn = np.asarray(X, dtype=np.float64)
    return Xn[np.flatnonzero(~np.isnan(Xn).any(axis=1))[:k]]


# -- pure functions against the reference's ------------------------------------------------


def test_form_constants_are_the_references():
    assert core.NUMERIC_INPUTS == ref_core.NUMERIC_INPUTS
    assert core.CHECKBOX_INPUTS == ref_core.CHECKBOX_INPUTS
    assert core.HARDSHIP_OPTIONS == ref_core.HARDSHIP_OPTIONS


@pytest.mark.parametrize("hardship", core.HARDSHIP_OPTIONS)
@pytest.mark.parametrize("checked", [(), ("grade_E", "application_type_Joint_App"),
                                     tuple(f for f, _ in core.CHECKBOX_INPUTS)])
def test_payloads_are_the_references(hardship, checked):
    numeric = {f: d + i for i, (f, _, d) in enumerate(core.NUMERIC_INPUTS)}
    boxes = {f: True for f in checked}
    got = core.build_single_payload(numeric, boxes, hardship)
    want = ref_core.build_single_payload(numeric, boxes, hardship)
    assert got == want and list(got) == list(want)
    assert {k: type(v) for k, v in got.items()} == {k: type(v) for k, v in want.items()}


def test_payload_matches_serving_schema():
    payload = default_form_payload()
    assert set(payload) == set(schema.SERVING_FEATURES)
    assert payload["hardship_status_No Hardship"] == 1
    assert payload["application_type_Joint App"] == 0
    assert payload["grade_E"] == 1
    row = validate_single_input(payload)
    assert row["loan_amnt"] == 10000.0


def test_unknown_hardship_rejected():
    numeric = {f: d for f, _, d in core.NUMERIC_INPUTS}
    with pytest.raises(ValueError):
        core.build_single_payload(numeric, {}, "NOT_A_STATUS")


def _items(wf) -> list[tuple]:
    return [(i.label, i.value, i.start) for i in wf.items]


@pytest.mark.parametrize("max_display", [3, 10, 20, 25])
def test_waterfalls_are_the_references_item_by_item(ui_env, max_display):
    resp = ui_env.predict(default_form_payload())
    got, want = core.build_waterfall(resp, max_display), ref_core.build_waterfall(resp, max_display)
    assert (got.base_value, got.fx) == (want.base_value, want.fx)
    assert _items(got) == _items(want)


def test_coerced_columns_are_the_references():
    records = [
        {"loan_amnt": 1000.0, "term": 36, "prob_default": 0.25, "note": "null"},
        {"loan_amnt": "null", "term": 60, "prob_default": 0.5, "note": "x", "extra": 1.5},
        {"loan_amnt": 2.5e3, "term": "60", "prob_default": "null", "note": None},
    ]
    got = core.coerce_results_frame(records)
    want = ref_core.coerce_results_frame(records)
    assert list(got) == list(want.columns)
    for name, col in got.items():
        assert col.dtype == np.float64
        np.testing.assert_array_equal(col, want[name].to_numpy(dtype=np.float64))
    assert core.frame_rows(got) == len(want)
    assert core.frame_rows({}) == 0


def test_importance_series_is_the_references():
    top = [{"feature": f, "importance": float(v)}
           for f, v in zip(schema.SERVING_FEATURES[:10], [3.5, 9.25, 0.5, 7, 1, 2, 8, 4, 6, 5])]
    got = core.importance_series(top)
    want = ref_core.importance_series(top)
    assert got == list(want.items())


def test_bulk_flow_results_importances_and_row_payloads(ui_env, live):
    _, X = live
    sample = pd.DataFrame(np.asarray(X[:8]), columns=list(schema.SERVING_FEATURES))
    records = ui_env.predict_bulk_csv("sample.csv", sample.to_csv(index=False).encode())
    frame = core.coerce_results_frame(records)
    ref_frame = ref_core.coerce_results_frame(records)
    assert core.frame_rows(frame) == 8 and "prob_default" in frame
    assert np.all((frame["prob_default"] >= 0) & (frame["prob_default"] <= 1))
    for name, col in frame.items():
        np.testing.assert_array_equal(col, ref_frame[name].to_numpy(dtype=np.float64))

    importance = ui_env.feature_importance_bulk(records)
    imp = core.importance_series(importance)
    assert 0 < len(imp) <= 10
    assert [v for _, v in imp] == sorted((v for _, v in imp), reverse=True)
    assert all(name in schema.SERVING_FEATURES for name, _ in imp)
    assert imp == list(ref_core.importance_series(importance).items())

    complete = _complete_rows(X, 4)
    records = ui_env.predict_bulk_csv(
        "complete.csv", pd.DataFrame(complete, columns=list(schema.SERVING_FEATURES)).to_csv(index=False).encode()
    )
    frame, ref_frame = core.coerce_results_frame(records), ref_core.coerce_results_frame(records)
    for idx in range(4):
        payload = core.results_row_payload(frame, idx)
        assert payload == ref_core.results_row_payload(ref_frame, idx)
        assert ui_env.predict(payload)["prob_default"] == pytest.approx(frame["prob_default"][idx], abs=1e-6)
    with pytest.raises(ValueError, match="out of range"):
        core.results_row_payload(frame, 4)
    frame["loan_amnt"][0] = np.nan
    with pytest.raises(ValueError, match="lacks features"):
        core.results_row_payload(frame, 0)
    lines = core.results_csv(frame).splitlines()
    assert lines[0].split(",") == list(frame)
    back = np.array([[float(c) if c else np.nan for c in line.split(",")] for line in lines[1:]])
    np.testing.assert_array_equal(back, np.stack(list(frame.values()), axis=1))


# -- the live server -------------------------------------------------------------------------


def test_single_prediction_waterfall_additivity(ui_env):
    resp = ui_env.predict(default_form_payload())
    assert 0.0 <= resp["prob_default"] <= 1.0
    wf = core.build_waterfall(resp, max_display=10)
    margin = math.log(resp["prob_default"] / (1 - resp["prob_default"]))
    assert wf.fx == pytest.approx(margin, abs=1e-4)
    assert wf.fx == pytest.approx(resp["base_value"] + sum(resp["shap_values"]), abs=1e-9)
    assert wf.base_value == pytest.approx(resp["base_value"])
    cum = wf.base_value
    for item in wf.items:
        assert item.start == pytest.approx(cum, abs=1e-9)
        cum += item.value
    assert cum == pytest.approx(wf.fx)
    assert len(wf.items) == 10
    assert wf.items[0].label == "11 other features"
    mags = [abs(i.value) for i in wf.items[1:]]
    assert mags == sorted(mags)


def test_waterfall_render_draws_all_bars(ui_env):
    wf = core.build_waterfall(ui_env.predict(default_form_payload()))
    fig, ax = plt.subplots()
    core.render_waterfall(ax, wf)
    ref_fig, ref_ax = plt.subplots()
    ref_core.render_waterfall(ref_ax, ref_core.build_waterfall(ui_env.predict(default_form_payload())))
    assert len(ax.patches) == len(wf.items) == len(ref_ax.patches)
    assert [t.get_text() for t in ax.get_yticklabels()] == [t.get_text() for t in ref_ax.get_yticklabels()]
    assert ax.get_xlabel() == ref_ax.get_xlabel()
    plt.close(fig)
    plt.close(ref_fig)


def test_admission_cap_sheds_as_service_degraded(served):
    store, _ = served
    cfg = ServeConfig(reliability=ReliabilityConfig(max_in_flight=1, shed_retry_after_s=2.5))
    service = ScorerService.from_store(store, cfg, device="cpu")
    server = make_async_server(service, "127.0.0.1", 0)
    sleeps: list[float] = []
    client = core.ApiClient(f"http://127.0.0.1:{server.port}", retries=2, sleep=sleeps.append)
    try:
        slot = service.admission.admit()
        slot.__enter__()
        try:
            with pytest.raises(core.ServiceDegraded) as ei:
                client.predict(default_form_payload())
        finally:
            slot.__exit__(None, None, None)
        assert ei.value.reason == "shed" and ei.value.retry_after_s == "3"
        assert sleeps == [3.0]
        assert 0 <= client.predict(default_form_payload())["prob_default"] <= 1
    finally:
        server.close()
        service.close()


# -- the client's degraded states against a scripted server -----------------------------------


class _Scripted(http.server.BaseHTTPRequestHandler):
    """Answers each POST with the next scripted (status, body, headers)."""

    script: list = []
    seen: list = []

    def do_POST(self):  # noqa: N802
        length = int(self.headers.get("Content-Length", "0"))
        type(self).seen.append((self.path, self.headers.get("Content-Type"), self.rfile.read(length)))
        status, body, headers = type(self).script.pop(0)
        data = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in headers.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *args):
        pass


@pytest.fixture
def scripted():
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Scripted)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    _Scripted.script, _Scripted.seen = [], []
    yield f"http://127.0.0.1:{server.server_address[1]}", _Scripted
    server.shutdown()
    server.server_close()


def _outcome(client_cls, url: str, handler, script: list) -> tuple:
    handler.script, handler.seen = list(script), []
    sleeps: list[float] = []
    client = client_cls(url, retries=2, sleep=sleeps.append, max_retry_after_s=5.0)
    try:
        result = ("ok", client.predict({"loan_amnt": 1.0}))
    except Exception as e:  # noqa: BLE001 - the outcome is what is compared
        result = (type(e).__name__, getattr(e, "reason", None), getattr(e, "retry_after_s", None),
                  getattr(e, "code", getattr(getattr(e, "response", None), "status_code", None)))
    return result, sleeps, len(handler.seen)


SCRIPTS = {
    "shed": [(429, {"error": "shed"}, {"Retry-After": "1"})] * 2,
    "shed_then_ok": [(429, {"error": "shed"}, {"Retry-After": "30"}), (200, {"prob_default": 0.5}, {})],
    "shed_no_header": [(429, {"error": "shed"}, {}), (200, {"prob_default": 0.25}, {})],
    "circuit_open": [(503, {"error": "circuit_open", "detail": "x"}, {"Retry-After": "2"})],
    "deadline": [(504, {"error": "deadline_exceeded", "detail": "x"}, {})],
    "not_ready": [(503, {"detail": "not ready"}, {})],
    "invalid": [(422, {"error": "invalid_input", "detail": "x"}, {})],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_degraded_states_map_as_the_references(scripted, name):
    url, handler = scripted
    got, got_sleeps, got_n = _outcome(core.ApiClient, url, handler, SCRIPTS[name])
    want, want_sleeps, want_n = _outcome(ref_core.ApiClient, url, handler, SCRIPTS[name])
    assert (got_sleeps, got_n) == (want_sleeps, want_n)
    if got[0] == "ok" or got[0] == "ServiceDegraded":
        assert got == want
    else:  # other statuses are HTTP errors in both clients' own exception type
        assert (got[0], want[0]) == ("HTTPError", "HTTPError") and got[3] == want[3]
    expected = {"shed": (("ServiceDegraded", "shed", "1", None), [1.0], 2),
                "shed_then_ok": (("ok", {"prob_default": 0.5}), [5.0], 2),
                "shed_no_header": (("ok", {"prob_default": 0.25}), [0.2], 2),
                "circuit_open": (("ServiceDegraded", "circuit_open", "2", None), [], 1),
                "deadline": (("ServiceDegraded", "deadline", None, None), [], 1)}
    if name in expected:
        assert (got, got_sleeps, got_n) == expected[name]
    if name in ("not_ready", "invalid"):
        assert isinstance(got, tuple) and got_n == 1


def test_bulk_upload_is_multipart_with_the_file(scripted):
    url, handler = scripted
    handler.script = [(200, {"predictions": [{"prob_default": 0.5}]}, {})]
    got = core.ApiClient(url).predict_bulk_csv("batch.csv", b"a,b\n1,2\n")
    assert got == [{"prob_default": 0.5}]
    path, ctype, body = handler.seen[0]
    assert path == "/predict_bulk_csv" and ctype.startswith("multipart/form-data; boundary=")
    assert b'name="file"; filename="batch.csv"' in body and b"a,b\n1,2\n" in body


def test_connection_errors_retry_with_backoff(monkeypatch):
    attempts = {"n": 0}
    real_send = core._send

    def flaky(url, body, ctype, timeout):
        attempts["n"] += 1
        if attempts["n"] < 3:
            raise ConnectionRefusedError("refused")
        return real_send(url, body, ctype, timeout)

    sleeps: list[float] = []
    monkeypatch.setattr(core, "_send", flaky)
    client = core.ApiClient("http://127.0.0.1:9", retries=3, backoff_s=0.2, sleep=sleeps.append)
    with pytest.raises(urllib.error.URLError):  # the third attempt reaches the closed port
        client.predict({"loan_amnt": 1.0})
    assert attempts["n"] == 3 and sleeps == [0.2, 0.4]


def test_connection_errors_exhaust_and_raise():
    sleeps: list[float] = []
    client = core.ApiClient("http://127.0.0.1:9", retries=3, sleep=sleeps.append)
    with pytest.raises(urllib.error.URLError):
        client.predict({})
    assert sleeps == [0.2, 0.4]


# -- the Streamlit shell under a stand-in module ----------------------------------------------


def test_app_module_imports_without_streamlit():
    from cobalt_smart_lender_ai_tpu_torch.ui import app

    assert callable(app.main)


class _Sidebar:
    def __init__(self, app):
        self.app = app

    def radio(self, label, options):
        self.app.calls.append(("sidebar.radio", label))
        return self.app.script["mode"]


class _Column:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _rows(df) -> int:
    return core.frame_rows(df) if isinstance(df, dict) else len(df)


class _FakeStreamlit(types.ModuleType):
    """Records every widget call; returns scripted values for inputs."""

    def __init__(self, script):
        super().__init__("streamlit")
        self.script = script
        self.calls: list[tuple] = []
        self.errors: list[str] = []
        self.figures: list = []
        self.sidebar = _Sidebar(self)
        self.session_state: dict = {}

    def set_page_config(self, **kw):
        self.calls.append(("set_page_config",))

    def title(self, text):
        self.calls.append(("title", text))

    def subheader(self, text):
        self.calls.append(("subheader", text))

    def caption(self, text):
        self.calls.append(("caption", text))

    def columns(self, n):
        return [_Column() for _ in range(n)]

    def number_input(self, label, value=0.0, min_value=None, max_value=None, step=None):
        self.calls.append(("number_input", label))
        return self.script.get("numbers", {}).get(label, value)

    def selectbox(self, label, options, index=0):
        self.calls.append(("selectbox", label))
        return self.script.get("selects", {}).get(label, options[index])

    def checkbox(self, label):
        self.calls.append(("checkbox", label))
        return label in self.script.get("checked", ())

    def button(self, label):
        self.calls.append(("button", label))
        return self.script.get("press_buttons", True)

    def file_uploader(self, label, type=None):
        self.calls.append(("file_uploader", label))
        return self.script.get("upload")

    def success(self, text):
        self.calls.append(("success", text))

    def warning(self, text):
        self.errors.append(str(text))

    def error(self, text):
        self.errors.append(str(text))

    def info(self, text):
        self.errors.append(str(text))  # explorer fallback counts as failure

    def pyplot(self, fig):
        self.figures.append(fig)

    def dataframe(self, df):
        self.calls.append(("dataframe", _rows(df)))

    def download_button(self, label, data, filename):
        self.calls.append(("download_button", filename))


class _Upload:
    def __init__(self, name, data):
        self.name = name
        self._data = data

    def getvalue(self):
        return self._data


def _run_app(monkeypatch, url, script):
    st = _FakeStreamlit(script)
    monkeypatch.setitem(sys.modules, "streamlit", st)
    monkeypatch.setenv("API_URL", url)
    from cobalt_smart_lender_ai_tpu_torch.ui import app

    app.main()
    return st


def test_single_prediction_mode_renders(monkeypatch, live):
    url, _ = live
    st = _run_app(monkeypatch, url, {"mode": "Single Prediction"})
    assert st.errors == []
    assert any(c[0] == "success" for c in st.calls)
    assert len(st.figures) == 1
    labels = [c[1] for c in st.calls if c[0] == "number_input"]
    assert len(labels) == 11  # 12 numeric inputs minus the term selectbox
    plt.close("all")


def test_bulk_mode_renders_table_importance_and_row_explorer(monkeypatch, live):
    url, X = live
    df = pd.DataFrame(_complete_rows(X, 6), columns=list(schema.SERVING_FEATURES))
    script = {
        "mode": "Bulk Prediction + SHAP",
        "upload": _Upload("batch.csv", df.to_csv(index=False).encode()),
        "numbers": {"Row to explain": 3},
    }
    st = _run_app(monkeypatch, url, script)
    assert st.errors == []
    assert ("dataframe", 6) in st.calls
    assert any(c[0] == "download_button" for c in st.calls)
    assert len(st.figures) == 2
    assert any(c[0] == "caption" and "Row 3" in c[1] for c in st.calls), st.calls

    from cobalt_smart_lender_ai_tpu_torch.ui import app

    st.script["press_buttons"] = False
    st.script["numbers"] = {"Row to explain": 5}
    app.main()
    assert st.errors == []
    assert any(c[0] == "caption" and "Row 5" in c[1] for c in st.calls), "explorer did not survive the rerun"
    plt.close("all")


def test_bulk_results_invalidate_on_new_upload_and_importance_is_cached(monkeypatch, live):
    from cobalt_smart_lender_ai_tpu_torch.ui import app

    url, X = live
    cols = list(schema.SERVING_FEATURES)
    rows = _complete_rows(X, 10)
    df_a = pd.DataFrame(rows[:4], columns=cols)
    df_b = pd.DataFrame(rows[4:10], columns=cols)

    counts = {"importance": 0}
    orig = core.ApiClient.feature_importance_bulk

    def counting(self, records):
        counts["importance"] += 1
        return orig(self, records)

    monkeypatch.setattr(core.ApiClient, "feature_importance_bulk", counting)
    script = {"mode": "Bulk Prediction + SHAP", "upload": _Upload("a.csv", df_a.to_csv(index=False).encode())}
    st = _run_app(monkeypatch, url, script)
    assert st.errors == []
    assert ("dataframe", 4) in st.calls
    assert counts["importance"] == 1

    st.script["press_buttons"] = False
    st.script["numbers"] = {"Row to explain": 2}
    app.main()
    assert st.errors == []
    assert counts["importance"] == 1, "importance re-posted on a rerun"

    st.script["upload"] = _Upload("b.csv", df_b.to_csv(index=False).encode())
    n_tables = sum(1 for c in st.calls if c[0] == "dataframe")
    app.main()
    assert st.errors == []
    assert sum(1 for c in st.calls if c[0] == "dataframe") == n_tables, "stale results rendered for a new upload"

    st.script["press_buttons"] = True
    app.main()
    assert st.errors == []
    assert ("dataframe", 6) in st.calls
    assert counts["importance"] == 2
    plt.close("all")


def test_degraded_service_warns_instead_of_erroring(monkeypatch, served):
    """A shed /predict renders the friendly warning, not an error."""
    store, _ = served
    cfg = ServeConfig(reliability=ReliabilityConfig(max_in_flight=1))
    service = ScorerService.from_store(store, cfg, device="cpu")
    server = make_async_server(service, "127.0.0.1", 0)
    slot = service.admission.admit()
    slot.__enter__()
    monkeypatch.setattr(core.time, "sleep", lambda s: None)
    try:
        st = _FakeStreamlit({"mode": "Single Prediction"})
        warnings: list[str] = []
        st.warning = warnings.append
        monkeypatch.setitem(sys.modules, "streamlit", st)
        monkeypatch.setenv("API_URL", f"http://127.0.0.1:{server.port}")
        from cobalt_smart_lender_ai_tpu_torch.ui import app

        app.main()
        assert st.errors == [] and len(warnings) == 1 and "capacity" in warnings[0]
    finally:
        slot.__exit__(None, None, None)
        server.close()
        service.close()
