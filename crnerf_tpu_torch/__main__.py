"""CLI dispatcher: ``python -m crnerf_tpu_torch <cmd> [flags]``.

The JAX package's commands: ``prepare`` (scene cache), ``train``, ``eval``
(the ``test_test``, ``test_train``, ``val`` and camera-path ``test``
splits), ``metrics`` (scores of saved renders), ``video`` (the
appearance-hallucination video) and ``serve``.
"""

from __future__ import annotations

import importlib
import sys

COMMANDS = {
    "prepare": "crnerf_tpu_torch.apps.prepare",
    "train": "crnerf_tpu_torch.apps.train",
    "eval": "crnerf_tpu_torch.apps.eval",
    "metrics": "crnerf_tpu_torch.apps.eval_metric",
    "video": "crnerf_tpu_torch.apps.video",
    "serve": "crnerf_tpu_torch.apps.serve",
}


def main():
    if len(sys.argv) < 2 or sys.argv[1] not in COMMANDS:
        print(f"usage: python -m crnerf_tpu_torch {{{'|'.join(COMMANDS)}}} "
              "[flags]\n")
        raise SystemExit(2)
    importlib.import_module(COMMANDS[sys.argv[1]]).main(sys.argv[2:])


if __name__ == "__main__":
    main()
