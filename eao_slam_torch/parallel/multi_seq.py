"""Many sequences at once over the ranks: batched BA solves and a
multi-sequence SLAM engine.

``batch_bundle_adjust`` solves S independent BA problems of one shape,
each rank its contiguous block of them (the list padded with inert copies
to a multiple of the rank count), and gathers the results on every rank.

``MultiSeqEngine`` tracks S independent monocular sequences. Each rank
owns a contiguous block of the sequences, as each device does under the
reference's ``shard_map``, and advances its own with the production
chunked tracker; there is no communication inside a chunk. The
between-chunk host passes run per sequence, so every trajectory is the
one the sequence gives when tracked alone. ``drain()`` replays each
deferred chunk's record bookkeeping (the keyframe slots of the monotonic
allocator, so before any compaction renumbers them), runs the
between-chunk passes once per sequence and then gathers every sequence's
trajectories, so that every rank can read every sequence after it.

With ``sync=False`` a chunk's between-chunk passes wait for ``drain()``,
map maintenance included, as in the reference: over enough deferred
chunks the keyframe and point allocators can pass the headroom that
maintenance keeps (the reference's ``parallel/multi_seq.py:210``). A guard
would belong to both packages.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from eao_slam_torch.geometry.camera import Camera
from eao_slam_torch.parallel.distributed import (Mesh, all_gather, all_gather_blocks,
                                                 block_range, line_mesh, psum)
from eao_slam_torch.solvers.ba import BAProblem, BAResult, bundle_adjust

SEQ_AXIS = "seq"


def stack_problems(problems: Sequence[BAProblem]) -> BAProblem:
    """Stack same-shape BAProblems along a leading axis."""
    return BAProblem(*(torch.stack(xs) for xs in zip(*problems)))


def pad_problems(problems: Sequence[BAProblem], n: int) -> list:
    """The list padded to length n with inert copies of the first problem
    (no valid observation, every camera fixed)."""
    out = list(problems)
    if out and len(out) < n:
        dummy = out[0]._replace(obs_valid=torch.zeros_like(out[0].obs_valid),
                                cam_fixed=torch.ones_like(out[0].cam_fixed))
        out = out + [dummy] * (n - len(out))
    return out


def make_seq_mesh(device=None) -> Mesh:
    """The one-axis ("seq") mesh over every rank."""
    return line_mesh(SEQ_AXIS, device)


def batch_bundle_adjust(cam: Camera, problems: Sequence[BAProblem], mesh: Mesh,
                        iters: int = 10) -> list:
    """Solve S same-shape BA problems, each rank its block; every rank
    returns all S results (a list of BAResult)."""
    S = len(problems)
    n = mesh.axis_size()
    S_pad = -(-S // n) * n
    per = S_pad // n
    lo = mesh.axis_index() * per
    padded = pad_problems(problems, S_pad)
    mine = [bundle_adjust(cam, p, iters=iters) for p in padded[lo:lo + per]]
    fields = [all_gather(torch.stack(xs), mesh) for xs in zip(*mine)]
    return [BAResult(*(f[i] for f in fields)) for i in range(S)]


def _records_array(records) -> np.ndarray:
    """(timestamp, T or None, state) records -> [n, 14] float64 rows (t,
    the 12 entries of T or NaN, state)."""
    out = np.full((len(records), 14), np.nan)
    for i, (t, T, st) in enumerate(records):
        out[i, 0] = t
        if T is not None:
            out[i, 1:13] = np.asarray(T, np.float64).reshape(12)
        out[i, 13] = st
    return out


def _records_from_array(a: np.ndarray) -> list:
    return [(float(r[0]), None if np.isnan(r[1]) else r[1:13].reshape(3, 4).astype(np.float32),
             int(r[13])) for r in a]


class MultiSeqEngine:
    """Track S independent monocular sequences over the ranks of ``mesh``
    (``make_seq_mesh``; None: every sequence on this process), each rank
    advancing its contiguous block of sequences with a ChunkedTracker.
    Every rank calls every method with the same arguments."""

    def __init__(self, cfg, n_seq: int, chunk: int = 32, mesh=None, device=None):
        from eao_slam_torch.runtime.scan_tracker import ChunkedTracker

        self.cfg = cfg
        self.chunk = chunk
        self.n_seq = n_seq
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        n_ranks = self.mesh.axis_size() if self.mesh is not None else 1
        if n_seq % n_ranks:
            raise ValueError(f"{n_seq} sequences not divisible over {n_ranks} ranks")
        lo, hi = block_range(n_seq, n_ranks, self.mesh.axis_index() if self.mesh else 0)
        self.owned = range(lo, hi)
        if device is None and mesh is not None:
            device = mesh.device
        # this rank's trackers; None for the sequences other ranks own
        self.trackers = [ChunkedTracker(cfg, chunk=chunk, device=device) if s in self.owned
                         else None for s in range(n_seq)]
        self.device = self.trackers[lo].device
        self._armed = [False] * n_seq
        self._deferred = []           # timestamps of each chunk awaiting drain()
        self._outs = {s: [] for s in self.owned}
        # every sequence's records and keyframe trajectory as of the last drain
        self._views = [None] * n_seq

    # -- per-sequence bootstrap ------------------------------------------

    def bootstrap(self, s: int, image, timestamp: float, boxes=None) -> bool:
        """Feed sequence s one bootstrap frame (its owner runs two-view
        init); True once s is armed, on every rank."""
        from eao_slam_torch.runtime.frame import frame_from_image

        ok = False
        if s in self.owned:
            fr = frame_from_image(self.cfg, image, self.device, boxes=boxes)
            ok = self.trackers[s].bootstrap(fr, timestamp)
        if self.mesh is not None:
            ok = bool(psum(torch.tensor([int(ok)], device=self.device), self.mesh)[0] > 0)
        self._armed[s] = ok
        return ok

    @property
    def armed(self) -> bool:
        return all(self._armed)

    # -- chunks -----------------------------------------------------------

    def track_images(self, images_u8, timestamps, boxes=None, box_class=None,
                     box_score=None, box_valid=None, sync: bool = True):
        """Advance every sequence one full chunk: images_u8 [S, C, H, W],
        timestamps [S, C] (and box arrays [S, C, B, ...] in an object
        mode). This rank tracks its own sequences; with ``sync`` the
        between-chunk passes and the gather follow (``drain``). Returns
        this rank's chunk outputs by sequence."""
        if not self.armed:
            raise RuntimeError("bootstrap every sequence first")
        ts = np.asarray(timestamps)
        S, C = ts.shape
        if S != self.n_seq or C != self.chunk:
            raise ValueError(f"batch [{S}, {C}] vs n_seq={self.n_seq}, chunk={self.chunk}")
        box_args = (boxes, box_class, box_score, box_valid)
        outs = {}
        for s in self.owned:
            kw = {} if boxes is None else dict(zip(
                ("boxes", "box_class", "box_score", "box_valid"),
                (np.asarray(b)[s] for b in box_args)))
            outs[s] = self.trackers[s]._dispatch_images(np.asarray(images_u8[s]), ts[s], **kw)
            self._outs[s].append(outs[s])
        self._deferred.append(ts)
        if sync:
            self.drain()
        return outs

    def drain(self) -> None:
        """Replay the deferred chunks' records, run the between-chunk passes
        once per sequence, then gather every sequence's trajectories."""
        if not self._deferred:
            return
        deferred, self._deferred = self._deferred, []
        for s in self.owned:
            t = self.trackers[s]
            for outs, ts in zip(self._outs[s], deferred):
                t._record_chunk(outs, np.asarray(ts[s], np.float32), t.kf_count_host)
            self._outs[s] = []
            t._between_chunk_passes()
        self._gather_views()

    def _gather_views(self) -> None:
        """Every sequence's records, keyframe trajectory and state, from
        its owner, on every rank (two collectives: the row counts, then
        the rows)."""
        rows = {}
        for s in self.owned:
            t = self.trackers[s]
            kts, kT = t.keyframe_trajectory()
            kf = np.concatenate([np.asarray(kts, np.float64)[:, None],
                                 np.asarray(kT, np.float64).reshape(-1, 12)], 1)
            rows[s] = (_records_array(t.records), kf)
        if self.mesh is None:
            self._views = [rows[s] for s in range(self.n_seq)]
            return
        counts = torch.zeros((self.n_seq, 2), dtype=torch.int64, device=self.device)
        for s, (rec, kf) in rows.items():
            counts[s] = torch.tensor([len(rec), len(kf)])
        counts = psum(counts, self.mesh).cpu().numpy()
        n = self.mesh.axis_size()
        blocks = [range(*block_range(self.n_seq, n, i)) for i in range(n)]
        per_rank = [int(counts[list(b)].sum()) for b in blocks]
        mine = np.concatenate([np.concatenate([rows[s][0], np.pad(
            rows[s][1], ((0, 0), (0, 1)), constant_values=np.nan)]) for s in self.owned])
        allr = all_gather_blocks(torch.as_tensor(mine, device=self.device), self.mesh, None,
                                 per_rank).cpu().numpy()
        off = 0
        for s in range(self.n_seq):
            nr, nk = counts[s]
            self._views[s] = (allr[off:off + nr], allr[off + nr:off + nr + nk, :13])
            off += nr + nk

    # -- per-sequence views -----------------------------------------------

    def _view(self, s: int) -> tuple:
        if self._views[s] is None:
            raise RuntimeError(f"sequence {s} belongs to another rank: read it after drain()")
        return self._views[s]

    def frame_trajectory(self, s: int):
        """(timestamps, T_cw [n, 3, 4]) of sequence s's tracked frames."""
        if s in self.owned:
            return self.trackers[s].frame_trajectory()
        recs = [(t, T) for t, T, _ in _records_from_array(self._view(s)[0]) if T is not None]
        ts = np.array([t for t, _ in recs])
        Ts = np.stack([T for _, T in recs]) if recs else np.zeros((0, 3, 4))
        return ts, Ts

    def keyframe_trajectory(self, s: int):
        """(timestamps, T_cw) of sequence s's live keyframes, in time
        order."""
        if s in self.owned:
            return self.trackers[s].keyframe_trajectory()
        kf = self._view(s)[1]
        return kf[:, 0].astype(np.float32), kf[:, 1:13].reshape(-1, 3, 4).astype(np.float32)

    def state(self, s: int) -> int:
        """Sequence s's tracking state after its last chunk."""
        if s in self.owned:
            return self.trackers[s].state
        return int(self._view(s)[0][-1, 13])
