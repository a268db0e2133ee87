"""DB inspector CLI (reference: `backend/view_db.py`).

Usage::

    python -m genrec_tpu_torch.backend.view_db --db app.db [--table students] [-n 5]
"""

from __future__ import annotations

import argparse
import json

from genrec_tpu_torch.backend.db import Database


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--db", default="app.db")
    ap.add_argument("--table", help="show head rows of one table")
    ap.add_argument("-n", type=int, default=5, help="rows to show")
    args = ap.parse_args(argv)

    db = Database(args.db)
    try:
        if args.table:
            rows = db.query(f"SELECT * FROM {args.table} LIMIT ?", (args.n,))
            print(json.dumps(rows, ensure_ascii=False, indent=2, default=str))
        else:
            for t in db.table_names():
                print(f"{t:<24} {db.count(t):>8} rows")
    except BrokenPipeError:  # e.g. `view-db | head`
        pass
    db.close()


if __name__ == "__main__":
    main()
