# Frozen copy of granite_tpu_torch/utils/logging.py at commit 757dbb804350, part of the
# benchmark's plain reference (benchmark/gref/README.md); kernel routes
# removed, so every call takes the plain PyTorch version.
"""Logging with Granite's severity API (copy of the LOGI/LOGW/LOGE
surface of granite_tpu/utils/logging.py; reference:
util/logging.hpp:48-78)."""

from __future__ import annotations

import logging
import sys

_logger = logging.getLogger("gref")
if not _logger.handlers:
    _handler = logging.StreamHandler(sys.stderr)
    _handler.setFormatter(logging.Formatter("[%(levelname).1s] %(message)s"))
    _logger.addHandler(_handler)
    _logger.setLevel(logging.INFO)


def LOGI(fmt: str, *args) -> None:
    _logger.info(fmt % args if args else fmt)


def LOGW(fmt: str, *args) -> None:
    _logger.warning(fmt % args if args else fmt)


def LOGE(fmt: str, *args) -> None:
    _logger.error(fmt % args if args else fmt)
