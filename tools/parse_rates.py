#!/usr/bin/env python3
"""Host parse rates of the port's CSV reader (``h2o_tpu_torch.io.parser``).

    python3 tools/parse_rates.py [--rows N] [--csv-rows M] [--device cpu]
                                 [--pkg DIR]

Writes ``chip_smoke``'s airlines CSV (seed 116) twice, plain and with the
header and string levels quoted as R's ``write.csv`` writes them, into the
git-ignored ``.chip_smoke/`` of the checkout, and prints one JSON line per
case:

- ``import_plain`` / ``import_quoted``: ``import_file`` of each file at
  ``--rows`` rows (default 7,009,728, the 2008 on-time file) onto
  ``--device`` (default ``cuda``), MB/s and rows/s;
- ``tokenize_plain`` / ``tokenize_quoted``: the tokenizer alone
  (``parser._tokenize``) on each file's bytes;
- ``csv_reader``: Python's ``csv`` reader over the quoted file's first
  ``--csv-rows`` rows (default 1,000,000: it builds one Python string per
  field), a yardstick with the same quoting rules.

Each wall is one run after the file is written (the page cache warm).
``--pkg DIR`` imports ``DIR/h2o_tpu_torch`` instead of this checkout's, so
two trees are timed in one call, in turns. Runs on the host; imports
nothing of JAX or of ``h2o_tpu``.
"""

from __future__ import annotations

import argparse
import csv
import io
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _case(what: str, nbytes: int, rows: int, fn) -> None:
    t0 = time.perf_counter()
    fn()
    s = time.perf_counter() - t0
    print(json.dumps(dict(case=what, rows=rows, bytes=nbytes, s=s,
                          mb_per_s=nbytes / 1e6 / s, rows_per_s=rows / s)),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=7_009_728)
    ap.add_argument("--csv-rows", type=int, default=1_000_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pkg", default=None)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke
    if args.pkg:
        sys.path.insert(0, os.path.abspath(args.pkg))
    from h2o_tpu_torch import import_file
    from h2o_tpu_torch.io import parser

    print(json.dumps(dict(pkg=os.path.dirname(os.path.dirname(
        parser.__file__)))), flush=True)

    os.makedirs(chip_smoke.DATA_DIR, exist_ok=True)
    path = os.path.join(chip_smoke.DATA_DIR, "parse_rates.csv")
    try:
        for quote in (False, True):
            tag = "quoted" if quote else "plain"
            chip_smoke._write_airlines_csv(path, args.rows, quote=quote)
            size = os.path.getsize(path)
            _case(f"import_{tag}", size, args.rows, lambda: import_file(
                path, col_types=chip_smoke.IMPORT_COL_TYPES,
                device=args.device))
            with open(path, "rb") as f:
                buf = f.read()
            _case(f"tokenize_{tag}", size, args.rows,
                  lambda: parser._tokenize(buf, ","))
        # the csv reader on a prefix of the quoted file: whole lines only
        cut = 0
        for _ in range(args.csv_rows + 1):
            cut = buf.index(b"\n", cut) + 1
        head = buf[:cut].decode()
        del buf
        _case("csv_reader", len(head), args.csv_rows, lambda: list(
            csv.reader(io.StringIO(head, newline=""))))
    finally:
        if os.path.exists(path):
            os.remove(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
