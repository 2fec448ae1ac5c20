"""Where trace bytes come from: the named-trace allowlist + bounded IO.

Two concerns, both security-shaped, live here:

- **The registry.** Tenants submit jobs that reference traces BY NAME;
  the server resolves names inside the operator-allowlisted
  ``KSIM_TRACES_DIR`` and nowhere else.  Raw file paths are refused at
  the job surface (ksim_tpu/jobs/manager.py) for the same reason
  ``initialSnapshotPath`` is: a tenant must never make the server read
  its own filesystem.  Names are bare filenames — no separators, no
  traversal, nothing hidden.
- **Bounded, gz-transparent line streaming.** ``open_trace_lines``
  yields decoded lines from a plain or gzip file (sniffed by magic
  bytes, not extension) while counting DECOMPRESSED bytes against
  ``KSIM_TRACES_MAX_BYTES`` — a tenant naming a pathological file (or a
  gzip bomb) cannot make a job worker chew unbounded input.  Parsers
  stream through this helper and never load a whole file.

Stdlib-only at import time (machine-checked: tools/ksimlint
import-boundary).
"""

from __future__ import annotations

import gzip
import os
from typing import IO, Iterable, Iterator

from ksim_tpu_torch.traces.schema import TraceError

__all__ = [
    "list_trace_entries",
    "list_traces",
    "open_trace_lines",
    "resolve",
    "trace_dir",
]

#: Default ``KSIM_TRACES_MAX_BYTES``: 64 MiB of (decompressed) input.
DEFAULT_MAX_BYTES = 64 * 1024 * 1024


def trace_dir() -> "str | None":
    """The operator's allowlisted trace directory (``KSIM_TRACES_DIR``),
    or None when the registry is not configured."""
    return os.environ.get("KSIM_TRACES_DIR") or None


def _valid_name(name: str) -> bool:
    return bool(name) and not (
        name.startswith(".")
        or "/" in name
        or "\\" in name
        or os.sep in name
        or name != os.path.basename(name)
    )


def resolve(name: str) -> str:
    """Resolve a registered trace name to its path under
    ``KSIM_TRACES_DIR``.  Raises ``TraceError`` when the registry is not
    configured, the name is not a bare filename, or nothing is
    registered under it."""
    base = trace_dir()
    if base is None:
        raise TraceError(
            "no trace registry configured (set KSIM_TRACES_DIR to the "
            "directory of registered traces)"
        )
    if not _valid_name(name):
        raise TraceError(f"invalid trace name {name!r} (bare filenames only)")
    path = os.path.join(base, name)
    if not os.path.isfile(path):
        raise TraceError(f"no registered trace {name!r} (have {list_traces()})")
    return path


def list_traces() -> list[str]:
    """Registered trace names (sorted); empty without a configured or
    readable registry directory."""
    base = trace_dir()
    if base is None:
        return []
    try:
        entries = os.listdir(base)
    except OSError:
        return []
    return sorted(
        e for e in entries if _valid_name(e) and os.path.isfile(os.path.join(base, e))
    )


def _sniff_format(path: str) -> str:
    """Best-effort format detection from the first non-blank line (gz
    transparent, bounded read): a JSON object is the Borg instance-event
    table, an 8/9-column CSV row is an Alibaba workload table, anything
    else — including unreadable or over-cap files — is ``"unknown"``.
    Advisory metadata only: job submission still names the format
    explicitly and the strict parsers remain the authority."""
    import json

    try:
        for line in open_trace_lines(path, max_bytes=1 << 20):
            text = line.strip()
            if not text:
                continue
            if text.startswith("{"):
                try:
                    return "borg" if isinstance(json.loads(text), dict) else "unknown"
                except ValueError:
                    return "unknown"
            if len(text.split(",")) in (8, 9):
                return "alibaba"
            return "unknown"
    except TraceError:
        return "unknown"
    return "unknown"


def list_trace_entries() -> list[dict]:
    """Registered traces with per-entry metadata — the ``GET
    /api/v1/traces`` shape: ``name`` / ``size_bytes`` (on-disk, NOT
    decompressed) / ``gzip`` (magic-byte sniff) / ``format`` (detected,
    advisory — see ``_sniff_format``).  Sorted by name like
    :func:`list_traces`; entries that disappear or turn unreadable
    mid-listing are skipped rather than failing the listing."""
    base = trace_dir()
    out: list[dict] = []
    if base is None:
        return out
    for name in list_traces():
        path = os.path.join(base, name)
        try:
            size = os.stat(path).st_size
            with open(path, "rb") as f:
                gz = f.read(2) == b"\x1f\x8b"
        except OSError:
            continue
        out.append(
            {
                "name": name,
                "size_bytes": size,
                "gzip": gz,
                "format": _sniff_format(path),
            }
        )
    return out


def _max_bytes() -> int:
    raw = os.environ.get("KSIM_TRACES_MAX_BYTES", "")
    try:
        return int(raw) if raw else DEFAULT_MAX_BYTES
    except ValueError:
        return DEFAULT_MAX_BYTES


def open_trace_lines(
    source: "str | os.PathLike | Iterable[str]",
    *,
    max_bytes: "int | None" = None,
) -> Iterator[str]:
    """Yield decoded text lines from ``source``.

    ``source`` may be a path (gzip sniffed by its magic bytes — the
    extension is not trusted) or any iterable of already-decoded lines
    (tests, in-memory snippets).  Streaming: one line in memory at a
    time; cumulative DECOMPRESSED bytes are capped by ``max_bytes``
    (default ``KSIM_TRACES_MAX_BYTES``, 0 = unbounded) and exceeding the
    cap raises ``TraceError`` instead of truncating silently — a
    half-read trace would compile to a stream that LOOKS valid."""
    if not isinstance(source, (str, bytes, os.PathLike)):
        yield from source
        return
    cap = _max_bytes() if max_bytes is None else max_bytes
    try:
        raw: IO[bytes] = open(source, "rb")
    except OSError as e:
        raise TraceError(f"cannot read trace {source!r}: {e}") from None
    with raw:
        magic = raw.read(2)
        raw.seek(0)
        stream: IO[bytes] = gzip.open(raw, "rb") if magic == b"\x1f\x8b" else raw
        seen = 0
        try:
            for line in stream:
                seen += len(line)
                if cap and seen > cap:
                    raise TraceError(
                        f"trace {os.path.basename(str(source))!r} exceeds the "
                        f"{cap}-byte bound (KSIM_TRACES_MAX_BYTES)"
                    )
                yield line.decode("utf-8", errors="strict")
        except (OSError, EOFError, UnicodeDecodeError) as e:
            # A truncated gzip member / undecodable bytes mid-stream:
            # the trace is corrupt, not merely short.
            raise TraceError(f"corrupt trace {source!r}: {e}") from None
