"""The raw table's bootstrap: the port's copy of the reference's
``data/bootstrap.py`` (its stand-in for the one-shot download that fills
the reference's data lake).

- `download_raw_archive` fetches a raw archive by URL (urllib) into the
  workspace, checked against its `REFERENCE_RAW_PINS` entry when its name is
  one of the reference's pinned datasets; without a network it fails at
  once with what to do instead.
- `bootstrap_synthetic` is the offline path: the full-schema synthetic
  LendingClub table (`data.synthetic`), written as the raw CSV with
  `io.frames.frame_to_csv` and pinned in a `DatasetRegistry`.

Either way the output is a raw CSV in the workspace and a named md5 pin;
`pipeline.run_pipeline` reads it through the store's ``data.raw_key``.

    python -m cobalt_smart_lender_ai_tpu_torch.data.bootstrap \\
        --workspace data/1-raw --rows 100000 --seed 0 [--store lake] [--url URL]
"""

from __future__ import annotations

import urllib.error
import urllib.request
from pathlib import Path

from cobalt_smart_lender_ai_tpu_torch.io.registry import (
    REFERENCE_RAW_PINS,
    DatasetRegistry,
    _md5,
)

__all__ = ["REFERENCE_DATA_URL", "bootstrap_synthetic", "download_raw_archive", "main"]

#: The reference's Drive folder, recorded for parity: any mirror serving the
#: same bytes passes the pin check.
REFERENCE_DATA_URL = (
    "https://drive.google.com/drive/folders/"
    "1I1QSqJOSrkC4rGYvFKQsHxxDh7zUGcV_?usp=drive_link"
)


def download_raw_archive(
    url: str,
    dest: str | Path,
    registry: DatasetRegistry | None = None,
    pin_name: str | None = None,
    timeout: float = 60.0,
) -> Path:
    """Fetch ``url`` to ``dest`` and, with a ``registry``, pin it as
    ``pin_name`` (default: ``dest``'s name). Raises ConnectionError, with
    what to do instead, when the URL cannot be read; a download named like a
    reference pin must match it, or nothing is written."""
    dest = Path(dest)
    if dest.is_dir():
        raise ValueError(
            f"destination {str(dest)!r} is a directory — pass the full file "
            "path the archive should be written to"
        )
    dest.parent.mkdir(parents=True, exist_ok=True)
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            data = r.read()
    except (urllib.error.URLError, OSError) as e:
        raise ConnectionError(
            f"cannot download {url!r}: {e}. On an air-gapped host, copy the "
            "archive in manually and register it with "
            "DatasetRegistry.add(name, path) — or use bootstrap_synthetic() "
            "for a full-schema offline stand-in."
        ) from e
    name = pin_name or dest.name
    known = {p.path: p for p in REFERENCE_RAW_PINS}
    if name in known:
        pin = known[name]
        got_md5, got_size = _md5(data), len(data)
        if (got_md5, got_size) != (pin.md5, pin.size):
            raise ValueError(
                f"download of {name!r} does not match its reference pin: "
                f"got md5={got_md5} size={got_size}, "
                f"pinned md5={pin.md5} size={pin.size} — refusing to save"
            )
    dest.write_bytes(data)
    if registry is not None:
        registry.add(name, data)
    return dest


def bootstrap_synthetic(
    workspace: str | Path,
    registry: DatasetRegistry | None = None,
    n_rows: int = 100_000,
    seed: int = 0,
    name: str = "Loan_status_synthetic.csv",
) -> Path:
    """Synthesize the full-schema raw table, write it to
    ``workspace/name`` as CSV and, with a ``registry``, pin it. Returns the
    CSV's path."""
    from cobalt_smart_lender_ai_tpu_torch.data.synthetic import synthetic_lendingclub_frame
    from cobalt_smart_lender_ai_tpu_torch.io.frames import frame_to_csv

    workspace = Path(workspace)
    workspace.mkdir(parents=True, exist_ok=True)
    data = frame_to_csv(synthetic_lendingclub_frame(n_rows=n_rows, seed=seed))
    path = workspace / name
    path.write_bytes(data)
    if registry is not None:
        registry.add(name, data)
    return path


def main(argv=None) -> Path:
    """Fetch with ``--url`` (pinned when ``--store`` names a store), or
    synthesize the offline full-schema stand-in."""
    import argparse

    from cobalt_smart_lender_ai_tpu_torch.io.store import ObjectStore

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workspace", default="data/1-raw")
    ap.add_argument("--url", default=None, help="fetch this URL instead of synthesizing")
    ap.add_argument("--rows", type=int, default=100_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--store", default=None,
        help="object-store root; when given, the download or the synthetic "
        "table is md5-pinned in its DatasetRegistry",
    )
    args = ap.parse_args(argv)

    registry = DatasetRegistry(ObjectStore(args.store)) if args.store else None
    if args.url:
        from urllib.parse import urlparse

        url_path = urlparse(args.url).path
        fname = Path(url_path).name
        if not fname or url_path.endswith("/"):
            ap.error(
                f"--url {args.url!r} has no file name in its path — "
                "directory-style URLs (e.g. a Drive folder link) carry no "
                "downloadable file; point at the file itself"
            )
        path = download_raw_archive(args.url, Path(args.workspace) / fname, registry)
    else:
        path = bootstrap_synthetic(args.workspace, registry, n_rows=args.rows, seed=args.seed)
    print(path)
    return path


if __name__ == "__main__":
    main()
