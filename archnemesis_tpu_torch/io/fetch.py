"""Chunked resource fetching for line-database acquisition.

Port of the JAX package's ``io/fetch.py`` (reference
database/utils/fetch.py:20-48: urllib chunked reads with progress
logging). Supports http(s) and file:// URLs through the standard library;
environments without network egress get a clear, actionable error instead
of a hang. Nothing in the package calls it: a caller downloads a catalogue
and points the readers at the local copy.
"""

from __future__ import annotations

import logging
import os
import urllib.error
import urllib.request
from pathlib import Path
from typing import Iterator, Optional

_lgr = logging.getLogger(__name__)

PROGRESS_INTERVAL_KB: Optional[float] = 1024


class FetchError(RuntimeError):
    pass


def file_in_chunks(url: str, *, chunk_size: Optional[int] = 1024 * 1024,
                   encoding: Optional[str] = "ascii",
                   timeout: float = 30.0) -> Iterator[bytes | str]:
    """Iterate a remote (or file://) resource in ``chunk_size`` pieces
    (reference file_in_chunks, fetch.py:20). ``chunk_size=None`` iterates
    lines; ``encoding=None`` yields bytes."""
    req = urllib.request.Request(url)
    _lgr.info("fetching %s", url)
    try:
        resp = urllib.request.urlopen(req, timeout=timeout)
    except (urllib.error.URLError, OSError) as e:
        raise FetchError(
            f"could not fetch {url!r}: {e}. This environment may have no "
            "network egress — download the resource elsewhere and point "
            "the database path at the local copy (file:// URLs work)."
        ) from e
    fetched = 0
    next_report = (PROGRESS_INTERVAL_KB or 0) * 1024
    with resp:
        while True:
            chunk = resp.readline() if chunk_size is None else resp.read(
                chunk_size)
            if not chunk:
                return
            fetched += len(chunk)
            if PROGRESS_INTERVAL_KB and fetched >= next_report:
                _lgr.info("fetched %.1f MB", fetched / 1048576.0)
                next_report += PROGRESS_INTERVAL_KB * 1024
            yield chunk.decode(encoding) if encoding else chunk


def download(url: str, dest: str, *, chunk_size: int = 1024 * 1024,
             overwrite: bool = False, timeout: float = 30.0) -> str:
    """Download ``url`` to ``dest`` in chunks; returns the written path.
    Skips the fetch when the file already exists (the reference's local
    HDF5 caches behave the same way) unless ``overwrite``."""
    dest_p = Path(dest)
    if dest_p.exists() and not overwrite:
        _lgr.info("using cached %s", dest)
        return str(dest_p)
    dest_p.parent.mkdir(parents=True, exist_ok=True)
    tmp = str(dest_p) + ".part"
    try:
        with open(tmp, "wb") as f:
            for chunk in file_in_chunks(url, chunk_size=chunk_size,
                                        encoding=None, timeout=timeout):
                f.write(chunk)
        os.replace(tmp, dest_p)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return str(dest_p)
