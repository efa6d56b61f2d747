"""Crash-safe training snapshots (counterpart of
ydf_tpu/utils/snapshot.py: the same files, byte for byte, for the same
arrays and metadata).

The reference's snapshot-index protocol
(`ydf/utils/snapshot.h:16-49` AddSnapshot/GetGreatestSnapshot +
`max_kept_snapshots`): a snapshot payload file is written FIRST, and only
then is its index appended to the `snapshot` index file — a crash between
the two leaves the previous snapshot as the recoverable latest. Stale
payloads beyond `max_kept` are pruned.

Durability. The payload-before-index ordering is only a real invariant
if each step is DURABLE before the next begins: `os.replace` alone is
atomic in the namespace but nothing forces the payload's data blocks (or
the rename's directory entry) to disk before the index rename — after a
power cut, ext4/xfs may persist the index rename while the payload data
is still garbage, losing BOTH files and with them the invariant. Every
write therefore runs fsync-before-rename (payload file, index file) and
fsyncs the directory after each rename, matching the crash-consistency
recipe the reference relies on its filesystem layer for.

Reader-side robustness is unconditional: `latest()` walks the index from
newest to oldest and skips unreadable/torn payloads, so even a snapshot
written by a pre-fsync build (or torn by the `snapshot.save=torn_write`
failpoint) degrades to the previous snapshot instead of a crash.

Payloads are npz archives of flat arrays plus a JSON metadata blob.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ydf_tpu_torch.utils import failpoints, telemetry


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    # Directory fsync publishes the rename's dentry (POSIX leaves rename
    # durability to an explicit fsync of the containing directory).
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    except OSError:
        pass  # some filesystems refuse fsync on directories; best effort
    finally:
        os.close(fd)


def _durable_replace(tmp: str, dst: str) -> None:
    """fsync(tmp) → rename → fsync(dir): dst is atomic AND durable."""
    _fsync_file(tmp)
    os.replace(tmp, dst)
    _fsync_dir(os.path.dirname(dst) or ".")


class Snapshots:
    def __init__(self, directory: str, max_kept: int = 3):
        self.directory = directory
        self.max_kept = max_kept
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ #

    def _index_path(self) -> str:
        return os.path.join(self.directory, "snapshot")

    def _payload_path(self, idx: int) -> str:
        return os.path.join(self.directory, f"snapshot_{idx}.npz")

    def indices(self) -> List[int]:
        if not os.path.isfile(self._index_path()):
            return []
        with open(self._index_path()) as f:
            out = []
            for line in f:
                line = line.strip()
                if line.isdigit():
                    out.append(int(line))
        return sorted(set(out))

    # ------------------------------------------------------------------ #

    def save(self, idx: int, arrays: Dict[str, np.ndarray],
             meta: Optional[dict] = None) -> None:
        """Write payload (fsynced), then record the index (fsynced) —
        the crash-safe order, made durable. The `snapshot.save` failpoint
        supports torn_write: it simulates the pre-fsync failure mode (a
        torn payload whose index entry survived) and `latest()` must
        fall back past it."""
        payload = dict(arrays)
        payload["__meta__"] = np.frombuffer(
            json.dumps(meta or {}).encode("utf-8"), dtype=np.uint8
        )
        act = failpoints.hit("snapshot.save")
        tmp = self._payload_path(idx) + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        if act == "torn_write":
            # Simulated crash: the payload reaches its final name TORN
            # (half its bytes) while the index update below still lands —
            # exactly the reordering fsync prevents on a real crash.
            with open(tmp, "rb") as f:
                raw = f.read()
            os.remove(tmp)
            with open(self._payload_path(idx), "wb") as f:
                f.write(raw[: max(len(raw) // 2, 1)])
            self._write_index(
                [i for i in self.indices() if i != idx] + [idx]
            )
            raise failpoints.FailpointError(
                f"injected torn write at 'snapshot.save' (idx {idx})"
            )
        _durable_replace(tmp, self._payload_path(idx))
        if telemetry.ENABLED:
            telemetry.counter("ydf_snapshot_saves_total").inc()
            telemetry.counter("ydf_snapshot_bytes_written_total").inc(
                os.path.getsize(self._payload_path(idx))
            )
        failpoints.hit("snapshot.index")
        idxs = [i for i in self.indices() if i != idx] + [idx]
        self._write_index(idxs)
        # Prune old payloads (keep the newest max_kept).
        for old in idxs[: -self.max_kept]:
            try:
                os.remove(self._payload_path(old))
            except OSError:
                pass

    def _write_index(self, idxs: List[int]) -> None:
        tmp = self._index_path() + ".tmp"
        with open(tmp, "w") as f:
            f.write("\n".join(str(i) for i in idxs) + "\n")
        _durable_replace(tmp, self._index_path())

    def latest(self) -> Optional[Tuple[int, Dict[str, np.ndarray], dict]]:
        """(index, arrays, meta) of the greatest readable snapshot."""
        for idx in reversed(self.indices()):
            path = self._payload_path(idx)
            if not os.path.isfile(path):
                continue
            try:
                with np.load(path) as z:
                    arrays = {k: z[k] for k in z.files if k != "__meta__"}
                    meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
                if telemetry.ENABLED:
                    telemetry.counter("ydf_snapshot_loads_total").inc()
                return idx, arrays, meta
            except Exception:
                if telemetry.ENABLED:
                    # A torn/corrupt payload was skipped for an older one
                    # — the recovery event worth counting.
                    telemetry.counter(
                        "ydf_snapshot_fallback_total"
                    ).inc()
                continue  # partially written / corrupt → try older
        return None
