"""Shared logging setup: stdlib logging with a compact format, under the
``ganq_tpu_torch`` logger namespace."""

from __future__ import annotations

import logging
import os
import sys

_CONFIGURED = False


def get_logger(name: str = "ganq_tpu_torch") -> logging.Logger:
    global _CONFIGURED
    if not _CONFIGURED:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname).1s %(name)s: %(message)s", "%H:%M:%S"))
        root = logging.getLogger("ganq_tpu_torch")
        root.addHandler(handler)
        root.setLevel(os.environ.get("GANQ_TPU_LOGLEVEL", "INFO"))
        root.propagate = False
        _CONFIGURED = True
    return logging.getLogger(name if name.startswith("ganq_tpu_torch")
                             else f"ganq_tpu_torch.{name}")


__all__ = ["get_logger"]
