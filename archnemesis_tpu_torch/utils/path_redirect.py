"""Relocatable table paths (reference helpers/path_redirect.py).

Run decks store absolute table LOCATIONs (k-tables, line data, CIA); moving
a run between machines breaks them. The reference wraps location lists in a
``PathRedirectList`` that rewrites configured prefixes on access; here the
same prefix-rewrite is exposed both as the class (API parity) and as a
process-wide redirect table consulted by the io loaders
(``resolve_path``). Host code, the same in both packages.
"""

from __future__ import annotations

import os
from typing import Iterable, Tuple

_REDIRECTS: Tuple[Tuple[str, str], ...] = ()


def set_path_redirects(redirects: Iterable[Tuple[str, str]]) -> None:
    """Install process-wide (prefix, replacement) rewrites applied by every
    deck/table loader. Longest-prefix wins; pass () to clear."""
    global _REDIRECTS
    _REDIRECTS = tuple(
        sorted(redirects, key=lambda kv: len(kv[0]), reverse=True)
    )


def get_path_redirects() -> Tuple[Tuple[str, str], ...]:
    return _REDIRECTS


def redirect_path(path: str) -> str:
    """Apply the installed prefix rewrites to one path."""
    for prefix, repl in _REDIRECTS:
        if path.startswith(prefix):
            return repl + path[len(prefix):]
    return path


def resolve_path(path: str, base: str) -> str:
    """Rewrite + resolve a table location: apply redirects, then anchor
    relative paths at ``base`` (the deck directory)."""
    p = redirect_path(path)
    return p if os.path.isabs(p) else os.path.join(base, p)


class PathRedirectList:
    """List of paths with prefix redirects applied on read access
    (reference helpers/path_redirect.py:3). Mutations operate on the raw
    stored paths."""

    def __init__(self, values=(), redirects: Tuple[Tuple[str, str], ...] = ()):
        self._path_redirects = dict(redirects)
        self._raw_paths = list(values)

    def _get(self, path):
        if isinstance(path, tuple):
            return tuple(self._get(p) for p in path)
        for k, v in self._path_redirects.items():
            if path.startswith(k):
                return v + path[len(k):]
        return path

    def append(self, value):
        self._raw_paths.append(value)

    def extend(self, values):
        self._raw_paths.extend(values)

    def __getitem__(self, i):
        return self._get(self._raw_paths[i])

    def __len__(self):
        return len(self._raw_paths)

    def __iter__(self):
        for p in self._raw_paths:
            yield self._get(p)

    def __repr__(self):
        return (f"PathRedirectList({self._raw_paths!r}, "
                f"redirects={tuple(self._path_redirects.items())!r})")
