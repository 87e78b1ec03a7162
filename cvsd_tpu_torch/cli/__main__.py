"""`python -m cvsd_tpu_torch.cli` — list the port's CLI entry points."""

from __future__ import annotations

import importlib
import pkgutil

import cvsd_tpu_torch.cli as cli_pkg


def main() -> None:
    print("cvsd_tpu_torch command-line entry points "
          "(python -m cvsd_tpu_torch.cli.<name>):\n")
    for info in sorted(pkgutil.iter_modules(cli_pkg.__path__), key=lambda m: m.name):
        if info.name.startswith("_") or info.name == "common":
            continue
        mod = importlib.import_module(f"cvsd_tpu_torch.cli.{info.name}")
        doc = (mod.__doc__ or "").strip().splitlines()
        print(f"  {info.name:<18} {doc[0] if doc else ''}")


if __name__ == "__main__":
    main()
