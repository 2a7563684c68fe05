"""Package-wide logging control (port of the JAX package's ``cfg/logs.py``;
reference ``cfg/logs.py:6-70``).

One root logger for the package with a push/pop level stack so callers can
temporarily silence subsystems (the reference uses this to quiet joblib
workers, ForwardModel_0.py:2163-2168; here it quiets per-iteration retrieval
chatter without touching the host application's logging config).
"""

from __future__ import annotations

import contextlib
import logging

pkg_logger = logging.getLogger("archnemesis_tpu_torch")
pkg_logger.propagate = False
if not pkg_logger.handlers:
    _handler = logging.StreamHandler()
    _handler.setLevel(logging.DEBUG)
    _handler.setFormatter(
        logging.Formatter(
            "%(levelname)s :: %(funcName)s :: %(filename)s-%(lineno)d :: "
            "%(message)s"
        )
    )
    pkg_logger.addHandler(_handler)
    pkg_logger.setLevel(logging.INFO)

_level_stack: list[dict[str, int]] = []


def _descendants(root: logging.Logger):
    yield root
    prefix = root.name + "."
    for name, lgr in logging.root.manager.loggerDict.items():
        if not isinstance(lgr, logging.PlaceHolder) and name.startswith(prefix):
            yield lgr


def set_packagewide_level(level: int, mode: str = "exact",
                          root: logging.Logger = pkg_logger) -> None:
    """Set every package logger's level. mode: 'exact' sets, 'min' lowers
    loggers above the level, 'max' raises loggers below it (reference
    set_packagewide_level semantics)."""
    for lgr in _descendants(root):
        if mode == "exact":
            lgr.setLevel(level)
        elif mode == "max":
            if lgr.level > level:
                lgr.setLevel(level)
        elif mode == "min":
            if lgr.level < level:
                lgr.setLevel(level)
        else:
            raise ValueError(f"unknown mode {mode!r}")


def push_packagewide_level(level: int, mode: str = "exact",
                           root: logging.Logger = pkg_logger) -> None:
    """Save current levels, then set_packagewide_level."""
    _level_stack.append({l.name: l.level for l in _descendants(root)})
    set_packagewide_level(level, mode=mode, root=root)


def pop_packagewide_level(root: logging.Logger = pkg_logger) -> None:
    """Restore the levels saved by the matching push."""
    if not _level_stack:
        raise RuntimeError("pop_packagewide_level without matching push")
    saved = _level_stack.pop()
    for lgr in _descendants(root):
        if lgr.name in saved:
            lgr.setLevel(saved[lgr.name])


@contextlib.contextmanager
def quiet(level: int = logging.WARNING):
    """Context manager: temporarily raise the package log threshold.

    Uses 'min' mode (raise any logger below ``level`` up to it) so loggers
    already stricter than ``level`` keep their threshold.
    """
    push_packagewide_level(level, mode="min")
    try:
        yield
    finally:
        pop_packagewide_level()
