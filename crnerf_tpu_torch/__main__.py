"""CLI dispatcher: ``python -m crnerf_tpu_torch <cmd> [flags]``.

Only ``serve`` is ported so far (the JAX package's ``prepare``, ``train``,
``eval``, ``metrics`` and ``video`` stay in ``python -m crnerf_tpu``).
"""

from __future__ import annotations

import importlib
import sys

COMMANDS = {"serve": "crnerf_tpu_torch.apps.serve"}


def main():
    if len(sys.argv) < 2 or sys.argv[1] not in COMMANDS:
        print(f"usage: python -m crnerf_tpu_torch {{{'|'.join(COMMANDS)}}} "
              "[flags]\n")
        raise SystemExit(2)
    importlib.import_module(COMMANDS[sys.argv[1]]).main(sys.argv[2:])


if __name__ == "__main__":
    main()
