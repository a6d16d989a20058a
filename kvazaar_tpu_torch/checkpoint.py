"""Record/replay debugging oracle (reference: src/checkpoint.c/h).

The reference's CHECKPOINTS mechanism is NOT encode-resume: with
CHECKPOINTS=record it logs structured state lines to __debug_ckpt.log;
with CHECKPOINTS=check a run asserts its state matches the recording
line by line (src/checkpoint.h:42-98; CHECKPOINT_CU dumps full CU
state, src/cu.h:154-182).  Same contract here at frame granularity:
each encoded frame logs POC, slice QP, NAL/slice type, bit count, and
content digests of the reconstruction planes and the syntax-element
tensors (the FrameData analogue of CHECKPOINT_CU).  A `check` run that
diverges raises CheckpointMismatch at the first differing line — the
bisection tool for "same config, different stream" regressions.

Enable via environment:
    CHECKPOINTS=record [CHECKPOINTS_FILE=__debug_ckpt.log]
    CHECKPOINTS=check  [CHECKPOINTS_FILE=__debug_ckpt.log]
"""

from __future__ import annotations

import hashlib
import os

import numpy as np


class CheckpointMismatch(AssertionError):
    pass


def _digest(arr) -> str:
    if arr is None:
        return "-"
    a = np.ascontiguousarray(arr)
    return hashlib.md5(a.tobytes()).hexdigest()[:16]


class Checkpointer:
    """One per encoder run; no-op unless CHECKPOINTS is set."""

    def __init__(self):
        self.mode = os.environ.get("CHECKPOINTS", "")
        self.path = os.environ.get("CHECKPOINTS_FILE",
                                   "__debug_ckpt.log")
        self._f = None
        self._lines = None
        self._idx = 0
        if self.mode == "record":
            self._f = open(self.path, "w")
        elif self.mode == "check":
            with open(self.path) as f:
                self._lines = [ln.rstrip("\n") for ln in f]

    @property
    def active(self) -> bool:
        return self.mode in ("record", "check")

    def mark_frame(self, poc: int, qp: int, nal_type: int,
                   slice_type: int, bits: int, rec, frame_data) -> None:
        """rec: (y, cb, cr) planes or (None, ...); frame_data: the
        FrameData syntax tensors (digested field by field)."""
        if not self.active:
            return
        fd_part = "-"
        if frame_data is not None:
            fields = []
            for name in sorted(vars(frame_data)):
                v = getattr(frame_data, name)
                if isinstance(v, np.ndarray):
                    fields.append(f"{name}={_digest(v)}")
            fd_part = ",".join(fields) or "-"
        line = (f"FRAME poc={poc} qp={qp} nal={nal_type} "
                f"slice={slice_type} bits={bits} "
                f"rec={_digest(rec[0])}/{_digest(rec[1])}/"
                f"{_digest(rec[2])} {fd_part}")
        if self.mode == "record":
            self._f.write(line + "\n")
            self._f.flush()
        else:
            if self._idx >= len(self._lines):
                raise CheckpointMismatch(
                    f"checkpoint log exhausted at frame poc={poc}")
            expect = self._lines[self._idx]
            self._idx += 1
            if line != expect:
                raise CheckpointMismatch(
                    f"checkpoint mismatch at line {self._idx}:\n"
                    f"  recorded: {expect}\n  current:  {line}")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
