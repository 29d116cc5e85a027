"""CLI dispatch: ``python -m variantcalling_tpu_torch <tool> <args>``.

Counterpart of ``variantcalling_tpu/__main__.py``; the port serves one tool
so far, ``filter_variants_pipeline``. Each tool is a module exposing
``run(argv)``, imported when called.
"""

from __future__ import annotations

import importlib
import logging
import sys

TOOLS: dict[str, str] = {
    "filter_variants_pipeline": "variantcalling_tpu_torch.pipelines.filter_variants",
}


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in {"-h", "--help"}:
        print("usage: python -m variantcalling_tpu_torch <tool> [tool args]\n\ntools:")
        for name in sorted(TOOLS):
            print(f"  {name}")
        return 0
    tool = argv[0]
    if tool not in TOOLS:
        print(f"unknown tool: {tool!r}; run with --help for the tool list", file=sys.stderr)
        return 2
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    from variantcalling_tpu_torch import knobs

    knobs.warn_unknown_env()  # a misspelt VCTPU_* name configures nothing: say so
    result = importlib.import_module(TOOLS[tool]).run(argv[1:])
    return result if isinstance(result, int) else 0


if __name__ == "__main__":
    sys.exit(main())
