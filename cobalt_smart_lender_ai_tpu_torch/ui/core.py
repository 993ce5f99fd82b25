"""Framework-free UI logic — everything the Streamlit shell (`app.py`) does
except draw widgets (the port's copy of the reference's ``ui/core.py``,
without pandas or ``requests``).

Each concern of the reference UI is a plain function over JSON-shaped
dicts: building the ``/predict`` body from form state with the two alias
renames, reconstructing a SHAP waterfall from a ``/predict`` response
(replacing ``shap.plots.waterfall``), coercing bulk results to numeric
columns, and the HTTP client. So the whole UI data path is testable against
the port's server without a browser, and the Streamlit layer stays a thin
render shell.

Bulk results are a "results frame": an insertion-ordered dict of float64
numpy columns by name (`coerce_results_frame`), with ``"null"`` (the
server's NaN) read as NaN. `ApiClient` speaks HTTP through
``urllib.request`` (no proxies: the server is the one named) and posts the
bulk CSV as ``multipart/form-data``.
"""

from __future__ import annotations

import io
import json as _json
import math
import secrets
import time
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import numpy as np

from cobalt_smart_lender_ai_tpu_torch.data import schema

__all__ = [
    "CHECKBOX_INPUTS",
    "HARDSHIP_OPTIONS",
    "NUMERIC_INPUTS",
    "ApiClient",
    "ServiceDegraded",
    "Waterfall",
    "WaterfallItem",
    "build_single_payload",
    "build_waterfall",
    "coerce_results_frame",
    "frame_rows",
    "importance_series",
    "render_waterfall",
    "results_csv",
    "results_row_payload",
]

#: The single-prediction form's numeric inputs, in the reference's widget
#: order with its default values.
NUMERIC_INPUTS: tuple[tuple[str, str, float], ...] = (
    ("loan_amnt", "Loan Amount", 10000.0),
    ("term", "Term (months)", 36.0),
    ("installment", "Installment", 300.0),
    ("fico_range_low", "FICO Range Low", 660.0),
    ("last_fico_range_high", "Last FICO High", 700.0),
    ("open_il_12m", "Open IL Last 12m", 1.0),
    ("open_il_24m", "Open IL Last 24m", 2.0),
    ("max_bal_bc", "Max Balance on Bank Card", 2000.0),
    ("num_rev_accts", "Number of Revolving Accounts", 10.0),
    ("pub_rec_bankruptcies", "Bankruptcies", 0.0),
    ("emp_length_num", "Employment Length (years)", 3.0),
    ("earliest_cr_line_days", "Days Since First Credit Line", 4000.0),
)

#: Checkbox indicator columns.
CHECKBOX_INPUTS: tuple[tuple[str, str], ...] = (
    ("grade_E", "Grade E"),
    ("home_ownership_MORTGAGE", "Home Ownership: Mortgage"),
    ("verification_status_Verified", "Verified Status"),
    ("application_type_Joint_App", "Joint Application"),
)

#: Hardship selectbox options — "ACTIVE" is the implicit all-zeros baseline.
HARDSHIP_OPTIONS = ("ACTIVE", "BROKEN", "COMPLETE", "COMPLETED", "No_Hardship")


def build_single_payload(
    numeric: Mapping[str, float],
    checkboxes: Mapping[str, bool],
    hardship: str,
) -> dict[str, float]:
    """Assemble the /predict request body from form state, applying the two
    alias renames so the wire keys are the canonical one-hot names with
    spaces."""
    if hardship not in HARDSHIP_OPTIONS:
        raise ValueError(f"unknown hardship status {hardship!r}")
    payload: dict[str, float] = {
        field: float(numeric[field]) for field, _, _ in NUMERIC_INPUTS
    }
    for field, _ in CHECKBOX_INPUTS:
        payload[field] = int(bool(checkboxes.get(field, False)))
    for status in HARDSHIP_OPTIONS[1:]:
        payload[f"hardship_status_{status}"] = int(hardship == status)
    for old, new in schema.SERVING_FIELD_ALIASES.items():
        if old in payload:
            payload[new] = payload.pop(old)
    return payload


@dataclass(frozen=True)
class WaterfallItem:
    """One bar: feature label, signed contribution, bar start position."""

    label: str
    value: float
    start: float


@dataclass(frozen=True)
class Waterfall:
    """Data for a SHAP waterfall plot, base value at the bottom accumulating
    to the final margin f(x) at the top (shap.plots.waterfall semantics)."""

    base_value: float
    fx: float
    items: tuple[WaterfallItem, ...]  # drawn bottom-to-top


def build_waterfall(
    prediction: Mapping[str, Any], max_display: int = 10
) -> Waterfall:
    """Waterfall bars from a /predict response: order features by |phi|
    descending, keep the top ``max_display - 1``, collapse the rest into one
    "N other features" bar drawn first (bottom), then accumulate from
    base_value so the last bar ends at f(x) = base + sum(phi)."""
    values = np.asarray(prediction["shap_values"], dtype=np.float64)
    features = list(prediction["features"])
    row = prediction["input_row"]
    base = float(prediction["base_value"])
    order = np.argsort(-np.abs(values))
    shown = list(order[: max_display - 1]) if len(order) > max_display - 1 else list(order)
    rest = [i for i in order if i not in set(shown)]

    # Bottom-to-top: collapsed remainder first, then ascending |phi| so the
    # largest contribution sits adjacent to f(x) at the top.
    bars: list[tuple[str, float]] = []
    if rest:
        bars.append((f"{len(rest)} other features", float(values[rest].sum())))
    for i in reversed(shown):
        x = row.get(features[i])
        label = f"{x:g} = {features[i]}" if x is not None else features[i]
        bars.append((label, float(values[i])))

    items = []
    cum = base
    for label, v in bars:
        items.append(WaterfallItem(label=label, value=v, start=cum))
        cum += v
    return Waterfall(base_value=base, fx=cum, items=tuple(items))


def render_waterfall(ax, wf: Waterfall, fmt: str = "{:+.2f}") -> None:
    """Draw a Waterfall onto the caller's matplotlib axes — the
    shap.plots.waterfall stand-in (red = pushes toward default, blue =
    away)."""
    pos_color, neg_color = "#d81b60", "#1e88e5"
    for y, item in enumerate(wf.items):
        ax.barh(
            y,
            item.value,
            left=item.start,
            color=pos_color if item.value >= 0 else neg_color,
            height=0.6,
        )
        ax.text(
            item.start + item.value / 2,
            y,
            fmt.format(item.value),
            va="center",
            ha="center",
            fontsize=8,
            color="white",
        )
    ax.axvline(wf.base_value, color="#999", lw=0.8, ls="--")
    ax.set_yticks(range(len(wf.items)))
    ax.set_yticklabels([item.label for item in wf.items], fontsize=8)
    ax.set_xlabel(
        f"margin (base {wf.base_value:.2f} → f(x) {wf.fx:.2f})", fontsize=8
    )


def _numeric(value: Any) -> float:
    """One cell as a number, NaN where it is not one (``"null"``, None)."""
    if isinstance(value, (bool, int, float, np.number)):
        return float(value)
    if isinstance(value, str):
        try:
            return float(value)
        except ValueError:
            return math.nan
    return math.nan


def coerce_results_frame(records: Sequence[Mapping[str, Any]]) -> dict[str, np.ndarray]:
    """Bulk predictions → a results frame: float64 columns by name, in the
    order keys first appear. The server serializes NaN cells as the string
    "null"; every cell is read back as a number, NaN where it is not one
    (or where a record lacks the key)."""
    records = list(records)
    names: dict[str, None] = {}
    for record in records:
        names.update(dict.fromkeys(record))
    return {
        name: np.array([_numeric(r.get(name)) for r in records], dtype=np.float64)
        for name in names
    }


def frame_rows(frame: Mapping[str, np.ndarray]) -> int:
    """Rows of a results frame."""
    return len(next(iter(frame.values()))) if frame else 0


def results_csv(frame: Mapping[str, np.ndarray]) -> str:
    """A results frame as CSV text (header row; NaN as an empty cell)."""
    lines = [",".join(frame)]
    for i in range(frame_rows(frame)):
        lines.append(",".join("" if math.isnan(c[i]) else repr(float(c[i])) for c in frame.values()))
    return "\n".join(lines) + "\n"


def results_row_payload(frame: Mapping[str, np.ndarray], idx: int) -> dict[str, float]:
    """Rebuild a /predict request body from row ``idx`` of a results frame —
    the data step behind the per-row SHAP explorer.

    The bulk CSV already carries the canonical (aliased) feature names, so
    the payload is the 20 contract columns of that row; int-typed indicator
    fields are rounded back from the frame's float coercion."""
    n = frame_rows(frame)
    if not 0 <= idx < n:
        raise ValueError(f"row {idx} out of range (0..{n - 1})")
    payload: dict[str, float] = {}
    missing = []
    for name in schema.SERVING_FEATURES:
        col = frame.get(name)
        v = None if col is None else float(col[idx])
        if v is None or math.isnan(v):
            missing.append(name)
            continue
        payload[name] = int(round(v)) if name in schema.SERVING_INT_FEATURES else v
    if missing:
        raise ValueError(f"bulk frame lacks features for row {idx}: {missing}")
    return payload


def importance_series(top_features: Sequence[Mapping[str, Any]]) -> list[tuple[str, float]]:
    """`/feature_importance_bulk` response → ``(feature, importance)`` pairs
    for the barh chart, highest importance first."""
    by_name = {item["feature"]: float(item["importance"]) for item in top_features}
    return sorted(by_name.items(), key=lambda kv: -kv[1])


class ServiceDegraded(RuntimeError):
    """The serving tier answered but declined to score right now — shedding
    load (429), circuit open on its store (503 circuit_open), or past the
    request deadline (504). These are operational states, not user mistakes;
    the UI shows them as a friendly "busy, try again" banner instead of a
    stack trace."""

    def __init__(self, message: str, *, reason: str, retry_after_s=None):
        super().__init__(message)
        self.reason = reason
        self.retry_after_s = retry_after_s


@dataclass
class _Response:
    """An HTTP answer, any status: what `ApiClient` reads."""

    url: str
    status_code: int
    reason: str
    headers: Any  # http.client.HTTPMessage: case-insensitive ``get``
    content: bytes

    def json(self) -> Any:
        return _json.loads(self.content.decode())

    def raise_for_status(self) -> None:
        if self.status_code >= 400:
            raise urllib.error.HTTPError(
                self.url, self.status_code, self.reason, self.headers, io.BytesIO(self.content)
            )


#: An opener that ignores proxy settings: the client talks to the server it
#: is given.
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))
#: Failures to reach the server (refused, reset, unresolvable), which the
#: client retries; an HTTP answer is never one of them.
_CONNECTION_ERRORS = (urllib.error.URLError, ConnectionError)


def _send(url: str, body: bytes, content_type: str, timeout: float) -> _Response:
    request = urllib.request.Request(
        url, data=body, method="POST", headers={"Content-Type": content_type}
    )
    try:
        with _OPENER.open(request, timeout=timeout) as resp:
            return _Response(url, resp.status, resp.reason, resp.headers, resp.read())
    except urllib.error.HTTPError as e:
        with e:
            return _Response(url, e.code, str(e.reason), e.headers, e.read())


def _multipart(files: Mapping[str, tuple[str, bytes, str]]) -> tuple[bytes, str]:
    """``{field: (filename, data, content type)}`` as a multipart/form-data
    body and its Content-Type."""
    boundary = secrets.token_hex(16)
    parts = []
    for field, (filename, data, ctype) in files.items():
        parts.append(
            f'--{boundary}\r\nContent-Disposition: form-data; name="{field}"; '
            f'filename="{filename}"\r\nContent-Type: {ctype}\r\n\r\n'.encode()
            + data
            + b"\r\n"
        )
    body = b"".join(parts) + f"--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


class ApiClient:
    """Minimal HTTP client for the three serving endpoints the UI calls,
    pulled out so tests can exercise the full wire path in-process."""

    def __init__(
        self,
        base_url: str,
        timeout: float = 30.0,
        retries: int = 3,
        backoff_s: float = 0.2,
        sleep=None,
        max_retry_after_s: float = 5.0,
    ):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.retries = retries
        self.backoff_s = backoff_s
        self.max_retry_after_s = max_retry_after_s
        self._sleep = sleep  # injectable for tests; None = time.sleep

    def _retry_after_s(self, r, attempt: int) -> float:
        """Server-suggested wait from ``Retry-After``, capped so a pessimistic
        server can't stall the UI; falls back to the client's own backoff."""
        headers = getattr(r, "headers", None) or {}
        try:
            suggested = float(headers.get("Retry-After"))
        except (TypeError, ValueError):
            suggested = self.backoff_s * (2**attempt)
        return min(max(suggested, 0.0), self.max_retry_after_s)

    @staticmethod
    def _degraded(r) -> ServiceDegraded | None:
        """Map shed/breaker/deadline statuses to `ServiceDegraded`; any other
        status is handled by raise_for_status."""
        status = getattr(r, "status_code", None)
        if status not in (429, 503, 504):
            return None
        try:
            body = r.json()
        except Exception:
            body = {}
        code = body.get("error") if isinstance(body, dict) else None
        if status == 429:
            return ServiceDegraded(
                "The scoring service is at capacity; please retry in a moment.",
                reason="shed",
                retry_after_s=(getattr(r, "headers", None) or {}).get(
                    "Retry-After"
                ),
            )
        if status == 503 and code == "circuit_open":
            return ServiceDegraded(
                "The model store is temporarily unavailable; "
                "the service is backing off. Please retry shortly.",
                reason="circuit_open",
                retry_after_s=(getattr(r, "headers", None) or {}).get(
                    "Retry-After"
                ),
            )
        if status == 504 or code == "deadline_exceeded":
            return ServiceDegraded(
                "The request took longer than the serving deadline; "
                "try a smaller batch or retry.",
                reason="deadline",
            )
        return None

    def _post(self, path: str, *, json: Any = None, files=None) -> Any:
        # Retry connection-level failures (server restarting, transient
        # network) with exponential backoff, and 429 sheds honoring the
        # server's Retry-After. Other HTTP error statuses are real answers —
        # a 422 will not get better by asking again.
        if files is not None:
            body, ctype = _multipart(files)
        else:
            body, ctype = _json.dumps(json).encode(), "application/json"
        sleep = self._sleep or time.sleep
        for attempt in range(self.retries):
            try:
                r = _send(self.base_url + path, body, ctype, self.timeout)
            except _CONNECTION_ERRORS:
                if attempt == self.retries - 1:
                    raise
                sleep(self.backoff_s * (2**attempt))
                continue
            if r.status_code == 429 and attempt < self.retries - 1:
                sleep(self._retry_after_s(r, attempt))
                continue
            break
        degraded = self._degraded(r)
        if degraded is not None:
            raise degraded
        r.raise_for_status()
        return r.json()

    def predict(self, payload: Mapping[str, float]) -> dict:
        return self._post("/predict", json=dict(payload))

    def predict_bulk_csv(self, filename: str, csv_bytes: bytes) -> list[dict]:
        resp = self._post(
            "/predict_bulk_csv", files={"file": (filename, csv_bytes, "text/csv")}
        )
        return resp["predictions"]

    def feature_importance_bulk(
        self, records: Sequence[Mapping[str, Any]]
    ) -> list[dict]:
        resp = self._post("/feature_importance_bulk", json={"data": list(records)})
        return resp["top_features"]
