"""Stream-state checkpoint/resume.

The reference has no training-style checkpoints; its resume model is
keyframe-granular stream restart (SURVEY.md §5.4): decode restarts from the
nearest keyframe with buffer invalidation (Manager.hx:244-249), and the
demux cursor restarts mid-file via the avi_part grammar
(AVIParser.hx:178-183, DataLoaderAVIIndexed.hx:596-597).

This module makes that model explicit and serializable for the batch
pipeline: a checkpoint is per-stream ``(keyframe index, frames decoded,
demux byte offset)`` — everything else (prev-frame buffer, entropy state) is
reconstructed by re-decoding from the keyframe, which is exactly the
reference's elastic-recovery unit (SURVEY.md §5.3).  For long GOPs an
optional pixel snapshot of the previous frame skips the re-decode, but the
entropy state of mid-GOP adaptive contexts cannot be snapshotted portably —
the keyframe is the durable boundary.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field



@dataclass
class StreamCursor:
    """Resumable position of one stream (SURVEY.md §5.4 equivalent)."""

    stream_id: str
    next_frame: int  # next frame index to decode
    keyframe: int  # nearest keyframe ≤ next_frame (restart point)
    byte_offset: int  # demux cursor (file offset of the keyframe's chunk)
    gop_index: int = 0

    def restart_point(self) -> tuple[int, int]:
        return (self.keyframe, self.byte_offset)


@dataclass
class PipelineCheckpoint:
    """Batch-decode snapshot: per-stream cursors + config echo."""

    cursors: list[StreamCursor] = field(default_factory=list)
    width: int = 0
    height: int = 0
    codec: str = ""

    def to_json(self) -> str:
        return json.dumps({
            "width": self.width, "height": self.height, "codec": self.codec,
            "cursors": [asdict(c) for c in self.cursors],
        })

    @staticmethod
    def from_json(s: str) -> "PipelineCheckpoint":
        d = json.loads(s)
        return PipelineCheckpoint(
            cursors=[StreamCursor(**c) for c in d["cursors"]],
            width=d["width"], height=d["height"], codec=d["codec"],
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @staticmethod
    def load(path: str) -> "PipelineCheckpoint":
        with open(path) as f:
            return PipelineCheckpoint.from_json(f.read())


def checkpoint_from_loader(stream_id: str, loader, manager) -> StreamCursor:
    """Capture a Manager/loader pair's position as a resumable cursor."""
    nf = manager.next_frame_to_decode
    kf = loader.get_nearest_keyframe(nf)
    # byte offset of the keyframe chunk when an index is present
    off = 0
    if getattr(loader, "indexes", None):
        f = loader.frames[kf] if kf < len(loader.frames) else None
        if f is not None and f.ix >= 0 and loader.indexes[f.ix].frames:
            x = loader.indexes[f.ix]
            off = x.base_offset + x.frames[kf - x.first_frame].off
    return StreamCursor(stream_id=stream_id, next_frame=nf, keyframe=kf,
                        byte_offset=off)


def resume_manager(manager, cursor: StreamCursor) -> None:
    """Restart decode at the checkpoint's keyframe (the reference's seek
    reset, Manager.hx:244-249): trash all ring buffers, rewind the decode
    cursor; the loader's seek machinery re-fetches the byte range on the
    next GetFrame."""
    manager.next_frame_to_decode = cursor.keyframe
    for b in manager.bufs:
        b.trash = True
    manager.frame_of_interest = max(cursor.next_frame - 1, 0)
