"""Task record log (blobstore/common/recordlog analog).

Reference counterpart: common/recordlog — the scheduler appends one JSON record
per finished background task (migrate/repair/delete) to a rotating file so
operators can audit what moved where; consumed by cli tooling. JSON-per-line
encoding over the shared RotatingFile rotor (utils/auditlog.py).
"""

from __future__ import annotations

import json

from chubaofs_tpu_torch.utils.auditlog import RotatingFile


class RecordLog:
    def __init__(self, logdir: str, name: str = "record",
                 max_bytes: int = 4 << 20, backups: int = 4):
        self._rotor = RotatingFile(logdir, name, max_bytes, backups)

    def encode(self, record: dict):
        self._rotor.write_line(json.dumps(record, separators=(",", ":")))

    def records(self) -> list[dict]:
        """Read back every retained record, oldest first, across rotations."""
        return [json.loads(line) for line in self._rotor.read_lines()]

    def close(self):
        self._rotor.close()
