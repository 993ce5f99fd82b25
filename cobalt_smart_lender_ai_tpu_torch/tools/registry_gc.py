"""Registry garbage collection: a keep-last-K sweep over published models.

Every retrain generation mints an immutable ``models/<name>/v<N>``
artifact; nothing on the serving path ever deletes one (channel pointers
must never dangle). This is the offline sweep: for each registered model it
keeps every version a channel (``latest``/``canary``/``previous``) still
points at plus the newest ``--keep-last`` versions, and deletes the rest —
record, artifact ``.npz``, content pin and features sidecar.

Dry-run by default: prints the would-delete report as JSON and touches
nothing until ``--apply`` is passed.

Usage:
    python -m cobalt_smart_lender_ai_tpu_torch.tools.registry_gc
        [--store artifacts] [--keep-last 2] [--apply]
"""

from __future__ import annotations

import argparse
import json
from typing import Sequence

__all__ = ["main"]


def main(argv: Sequence[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--store", default="artifacts")
    ap.add_argument("--registry-prefix", default="registry")
    ap.add_argument("--keep-last", type=int, default=2,
                    help="newest versions to keep per model, beyond whatever the channels pin")
    ap.add_argument("--apply", action="store_true",
                    help="actually delete (default is a dry-run report)")
    args = ap.parse_args(argv)

    from cobalt_smart_lender_ai_tpu_torch.io import ModelRegistry, ObjectStore

    registry = ModelRegistry(ObjectStore(args.store), prefix=args.registry_prefix)
    report = registry.gc(keep_last=args.keep_last, dry_run=not args.apply)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
