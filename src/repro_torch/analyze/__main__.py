"""CLI: ``python -m repro_torch.analyze [path ...]`` — run the port's
invariant linter.

Defaults to ``src/repro_torch``.  Prints one line per finding
(``path:line: [rule] message``) and exits 1 when any rule fired, so it
slots directly beside pyflakes in CI.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from .lint import lint_paths


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    paths = args or ["src/repro_torch"]
    findings = lint_paths(paths)
    for f in findings:
        print(f)
    if findings:
        print(f"repro_torch.analyze: {len(findings)} finding(s) in "
              f"{', '.join(paths)}", file=sys.stderr)
        return 1
    print(f"repro_torch.analyze: clean ({', '.join(paths)})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
