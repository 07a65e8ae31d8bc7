"""Loop closing: vocabulary-free place recognition, Sim3 verification,
essential-graph correction and global BA (the LoopClosing thread).

The reference package's ``runtime/loop_closing.py`` on tensors:

- place recognition: with a BoW database (the interactive tracker's
  ``kfdb`` and ``vocab``), KeyFrameDatabase::DetectLoopCandidates with the
  lowest covisible neighbour's BoW score as the minimum; without one (the
  chunked path), every keyframe's L2-normalised histogram over 8192 (byte
  position, byte value) words of its descriptors, scored with tf-idf
  weights (host numpy, as in the reference);
- DetectLoop's gates: covisible keyframes excluded, the lowest covisible
  neighbour's score as the minimum, and a candidate group seen on three
  consecutive keyframes;
- verification: brute matching + Sim3 RANSAC, then SearchBySim3 growth
  and the 5 + 10 Sim3 LM with a 20-inlier gate;
- correction: the essential graph with the loop keyframe fixed, point
  re-anchoring through each point's first keyframe, fusion of the
  duplicated loop points, then a global BA.

``tracker`` is the interactive MonoTracker or the chunked tracker's
``_LoopView`` (``runtime/scan_tracker.py``). The view serves covisibility
rows from one cached device product; a MonoTracker's are counted on the
host with ``np.isin``, as the reference counts them for it (the two
differ where a keyframe binds one point twice).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from eao_slam_torch.config import SystemConfig
from eao_slam_torch.geometry import se3, sim3
from eao_slam_torch.geometry.camera import project
from eao_slam_torch.ops import matching
from eao_slam_torch.runtime.keyframe_db import score_l1
from eao_slam_torch.runtime.local_mapping import run_local_ba
from eao_slam_torch.runtime.tracking_kernels import set_last_wins, set_rows_drop
from eao_slam_torch.solvers.pose_graph import PoseGraphProblem, optimize_essential_graph
from eao_slam_torch.solvers.sim3_solver import optimize_sim3_schedule, solve_sim3_ransac

N_WORDS = 32 * 256  # byte-position vocabulary: 32 positions x 256 values


def kf_signatures(desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """L2-normalised byte-position histograms of a batch of keyframes:
    desc [B, F, 8] int32, valid [B, F] -> [B, N_WORDS] float32. Each valid
    descriptor votes its byte value at each of its 32 byte positions. The
    votes are counted in int32, so the order of the scatter's additions
    cannot move a result."""
    B, F = desc.shape[:2]
    shifts = torch.arange(0, 32, 8, dtype=torch.int32, device=desc.device)
    bytes_ = ((desc[..., None] >> shifts) & 0xFF).reshape(B, F, 32)
    pos = torch.arange(32, dtype=torch.int32, device=desc.device)
    rows = torch.arange(B, device=desc.device)[:, None, None] * N_WORDS
    idx = rows + (pos * 256 + bytes_)                               # [B, F, 32]
    votes = valid[..., None].expand(B, F, 32).to(torch.int32)
    hist = torch.zeros(B * N_WORDS, dtype=torch.int32, device=desc.device)
    hist = hist.index_add_(0, idx.reshape(-1).long(), votes.reshape(-1))
    hist = hist.reshape(B, N_WORDS).to(torch.float32)
    return hist / torch.clamp(torch.linalg.norm(hist, dim=-1, keepdim=True), min=1e-9)


def kf_signature(desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """One keyframe's signature: desc [F, 8], valid [F] -> [N_WORDS]."""
    return kf_signatures(desc[None], valid[None])[0]


class LoopCloser:
    """Host orchestrator; owns per-keyframe signatures and the consistency
    state."""

    def __init__(self, cfg: SystemConfig):
        self.cfg = cfg
        self.cam = cfg.camera
        K = cfg.capacity.max_keyframes
        self.signatures = np.zeros((K, N_WORDS), np.float32)
        self.consistent_streak: dict = {}
        self.last_loop_order = -999  # insertion order of the last closed loop
        self.closed_loops = 0

    # ------------------------------------------------------------------

    def remap_slots(self, kf_remap: np.ndarray) -> None:
        """Carry detection state through a slot compaction: signatures move
        to their new slots, consistency groups re-key (dropping culled
        members), and the last-loop anchor maps to the nearest surviving
        predecessor."""
        K = len(kf_remap)
        kept = kf_remap >= 0
        new_sigs = np.zeros_like(self.signatures)
        new_sigs[kf_remap[kept]] = self.signatures[:K][kept]
        self.signatures = new_sigs
        new_streak: dict = {}
        for group, streak in self.consistent_streak.items():
            g2 = tuple(sorted(int(kf_remap[s]) for s in group
                              if 0 <= s < K and kf_remap[s] >= 0))
            if g2:
                new_streak[g2] = max(streak, new_streak.get(g2, 0))
        self.consistent_streak = new_streak
        if self.last_loop_order >= 0:
            upto = kf_remap[: self.last_loop_order + 1]
            self.last_loop_order = int(upto.max()) if (upto >= 0).any() else -999

    def on_keyframe(self, tracker, slot: int, signature=None, order=None) -> bool:
        """Detection (+ correction on success) for one keyframe. Returns
        True if a loop was closed (the view's map rewritten). ``signature``
        is the keyframe's precomputed signature; ``order`` its insertion
        order (needed when a backlog of keyframes is replayed)."""
        if signature is None:
            m = tracker.map
            signature = kf_signature(m.kf_desc[slot], m.kf_kp_valid[slot]).cpu().numpy()
        self.signatures[slot] = signature
        if order is None:
            order = len(tracker.kf_slots) - 1
        if order - self.last_loop_order < 10 or order < 10:
            return False
        for cand in self._detect(tracker, slot, order):
            if self._verify_and_correct(tracker, slot, cand):
                self.last_loop_order = order
                self.closed_loops += 1
                self.consistent_streak.clear()
                return True
        return False

    # ------------------------------------------------------------------

    def _covis_weights(self, tracker, slot: int) -> np.ndarray:
        """Shared points of ``slot`` with every keyframe: the tracker's own
        rows where it serves them, else a host count over the live
        keyframes' observation rows."""
        if hasattr(tracker, "covis_weights"):
            return tracker.covis_weights(slot)
        cur = tracker.kf_pt_host[slot]
        cur_set = cur[cur >= 0]
        w = np.zeros((self.cfg.capacity.max_keyframes,), np.int64)
        for s in tracker.kf_slots:
            if s == slot or not tracker.kf_valid_host[s]:
                continue
            other = tracker.kf_pt_host[s]
            w[s] = np.isin(cur_set, other[other >= 0]).sum()
        return w

    def _detect(self, tracker, slot: int, order: int) -> List[int]:
        """DetectLoop: score gate + 3-consecutive-keyframe consistency,
        through the tracker's BoW database when it has one, tf-idf
        signature scores otherwise. Returns the consistent candidates in
        score order.

        The signature branch's document frequency counts every valid
        keyframe of the view, also those later in a replayed backlog whose
        signatures are still zero: that is the reference's behaviour, kept
        for parity (``ROADMAP.md`` Queue 3)."""
        covis = self._covis_weights(tracker, slot)
        # temporal exclusion relative to THIS keyframe's order: its 8
        # predecessors and everything after it
        recent = set(tracker.kf_slots[max(0, order - 8):])
        kfdb = getattr(tracker, "kfdb", None)
        if kfdb is not None and tracker.vocab is not None:
            q = kfdb.vectors[slot]
            neigh = np.flatnonzero(covis >= 15)
            min_score = (max(float(score_l1(kfdb.vectors[neigh], q).min()), 0.05)
                         if neigh.size else 0.15)
            cands = kfdb.detect_loop_candidates(q, covis, tracker.covis_matrix(), min_score, slot)
            scored = [(1.0 - 1e-3 * i, s) for i, s in enumerate(cands)
                      if s not in recent and tracker.kf_valid_host[s]]
        else:
            K = self.cfg.capacity.max_keyframes
            docs = [s for s in tracker.kf_slots if tracker.kf_valid_host[s]]
            sigs = self.signatures[:K]
            df = (sigs[docs] > 0).sum(axis=0)
            idf = np.maximum(np.log(max(len(docs), 2) / (1.0 + df)), 0.0)
            w = sigs * idf[None, :]
            w = w / np.maximum(np.linalg.norm(w, axis=1), 1e-9)[:, None]
            scores = w @ w[slot]
            # minimum acceptable score = worst score among covisible neighbours
            neigh = covis >= 15
            min_score = max(float(scores[neigh].min()) if neigh.any() else 0.3, 0.05)
            scored = []
            for s in tracker.kf_slots:
                if s == slot or s in recent or not tracker.kf_valid_host[s]:
                    continue
                if covis[s] > 0:            # connected -> not a loop
                    continue
                if scores[s] >= min_score:
                    scored.append((float(scores[s]), s))
            scored.sort(reverse=True)
            scored = scored[:5]
        if not scored:
            self.consistent_streak.clear()
            return []

        # temporal consistency: a candidate's covisible neighbourhood must
        # intersect a group seen on consecutive keyframes 3 times
        new_streaks: dict = {}
        consistent: list = []
        for _, cand in scored:
            cand_covis = self._covis_weights(tracker, cand)
            group = {cand} | {s for s in tracker.kf_slots if cand_covis[s] >= 15}
            streak = 1
            for prev_group, prev_streak in self.consistent_streak.items():
                if group & set(prev_group):
                    streak = max(streak, prev_streak + 1)
            g = tuple(sorted(group))
            new_streaks[g] = max(streak, new_streaks.get(g, 0))
            if streak >= 3:
                consistent.append(cand)
        self.consistent_streak = new_streaks
        return consistent

    # ------------------------------------------------------------------

    def _verify_and_correct(self, tracker, slot: int, cand: int) -> bool:
        m = tracker.map
        P = self.cfg.capacity.max_points
        dev = m.pt_pos.device

        # stage 1: brute descriptor match between the two keyframes' mapped
        # features + Sim3 RANSAC (seed gate 8 inliers)
        pt1 = m.kf_pt_idx[slot]
        pt2 = m.kf_pt_idx[cand]
        q_valid = m.kf_kp_valid[slot] & (pt1 >= 0)
        t_valid = m.kf_kp_valid[cand] & (pt2 >= 0)
        idx, _, ok = matching.search_brute(m.kf_desc[slot], q_valid, m.kf_desc[cand], t_valid,
                                           max_dist=matching.TH_LOW, ratio=0.75)
        if int(ok.sum()) < 12:
            return False
        il = idx.long()
        scale2 = torch.as_tensor(tracker.scale2_np, device=dev)
        n_lv = scale2.shape[0]
        T1, T2 = m.kf_pose[slot], m.kf_pose[cand]
        xc1 = se3.apply(T1, m.pt_pos[torch.clamp(pt1, 0, P - 1).long()])
        xc2 = se3.apply(T2, m.pt_pos[torch.clamp(pt2[il], 0, P - 1).long()])
        s2_1 = scale2[torch.clamp(m.kf_octave[slot], 0, n_lv - 1).long()]
        s2_2 = scale2[torch.clamp(m.kf_octave[cand], 0, n_lv - 1).long()][il]
        res = solve_sim3_ransac(self.cam, xc1, xc2, ok, s2_1, s2_2,
                                generator=tracker.generator, n_hyp=512, min_inliers=8)
        if not bool(res.success):
            return False

        # stage 2: SearchBySim3 growth, then the 5 + 10 Sim3 optimisation
        # with the 20-inlier gate
        g_idx, g_ok = self._search_by_sim3(m, slot, cand, res.S12)
        gl = g_idx.long()
        p1g = pt1[gl]                       # slot-side point per cand feature
        pair_ok = g_ok & (pt2 >= 0) & (p1g >= 0)
        if int(pair_ok.sum()) < 20:
            return False
        xc1g = se3.apply(T1, m.pt_pos[torch.clamp(p1g, 0, P - 1).long()])
        xc2g = se3.apply(T2, m.pt_pos[torch.clamp(pt2, 0, P - 1).long()])
        s2_1g = scale2[torch.clamp(m.kf_octave[slot], 0, n_lv - 1).long()][gl]
        s2_2g = scale2[torch.clamp(m.kf_octave[cand], 0, n_lv - 1).long()]
        res = optimize_sim3_schedule(self.cam, res.S12, xc1g, xc2g, pair_ok,
                                     1.0 / s2_1g, 1.0 / s2_2g)
        if int(res.n_inliers) < 20:
            return False

        self._correct_loop(tracker, slot, cand, res.S12)
        self._fuse_loop_points(tracker, torch.clamp(p1g, 0, P - 1),
                               torch.clamp(pt2, 0, P - 1), pair_ok & res.inliers)
        if hasattr(tracker, "invalidate_covis"):
            tracker.invalidate_covis()   # fusion rewired observations
        # global BA over the fused, corrected map straightens the chain
        self._global_ba(tracker, fixed_slot=cand)
        return True

    def _search_by_sim3(self, m, slot: int, cand: int, S12):
        """Grow loop correspondences under a seed Sim3: the candidate's map
        points project into the current keyframe through S12 and match its
        mapped features by windowed descriptor NN (no octave gate).
        Returns (idx [F] slot feature per cand feature, ok [F])."""
        P = m.pt_pos.shape[0]
        pt1 = m.kf_pt_idx[slot]
        pt2 = m.kf_pt_idx[cand]
        X2c = se3.apply(m.kf_pose[cand], m.pt_pos[torch.clamp(pt2, 0, P - 1).long()])
        X_in1 = sim3.apply(S12, X2c)
        uv = project(self.cam, X_in1)
        q_valid = m.kf_kp_valid[cand] & (pt2 >= 0) & (X_in1[:, 2] > 0.05)
        t_valid = m.kf_kp_valid[slot] & (pt1 >= 0)
        dist = matching.hamming_matrix(m.kf_desc[cand], m.kf_desc[slot])
        mask = matching.window_mask(uv, m.kf_kp[slot], 15.0, q_valid, t_valid)
        idx, d, ok = matching.match_nn(dist, mask, max_dist=matching.TH_HIGH, ratio=0.9)
        ok = matching.resolve_duplicate_cols(idx, d, ok, pt1.shape[0])
        return idx, ok

    def _fuse_loop_points(self, tracker, p1, p2, inlier):
        """Replace the current side's duplicated points with the loop
        side's: every keyframe observation of p1 now references p2, and p1
        dies. Where two inlier pairs share a p1 the later pair wins, as the
        reference's scatter applies them on its CPU backend."""
        m = tracker.map
        P = m.pt_pos.shape[0]
        dev = m.pt_pos.device
        src = torch.where(inlier, p1, P).to(torch.int64)
        dst = torch.where(inlier, p2, P).to(torch.int32)
        order = torch.sort(src, stable=True).indices
        remap = torch.arange(P + 1, dtype=torch.int32, device=dev)
        remap = set_last_wins(remap, src[order], dst[order])[:P]

        kf_pt = m.kf_pt_idx
        kf_pt = torch.where(kf_pt >= 0, remap[torch.clamp(kf_pt, 0, P - 1).long()], kf_pt)
        pt_valid = set_rows_drop(m.pt_valid, src, False)
        tracker.map = m._replace(kf_pt_idx=kf_pt, pt_valid=pt_valid)
        tracker.kf_pt_host = kf_pt.cpu().numpy().copy()
        tracker.pt_valid_host = pt_valid.cpu().numpy().copy()

    def _correct_loop(self, tracker, slot: int, cand: int, S12):
        """CorrectLoop: essential-graph optimisation and point
        re-anchoring."""
        m = tracker.map
        dev = m.pt_pos.device
        K = self.cfg.capacity.max_keyframes
        slots = [s for s in tracker.kf_slots if tracker.kf_valid_host[s]]
        order_of = {s: i for i, s in enumerate(tracker.kf_slots)}
        st = torch.as_tensor(slots, dtype=torch.int64, device=dev)

        verts = sim3.identity(device=dev).repeat(K, 1)
        verts[st] = sim3.from_se3(m.kf_pose[st])

        # edges: temporal chain + strong covisibility + the loop edge
        ei, ej = [], []
        for a, b in zip(tracker.kf_slots[:-1], tracker.kf_slots[1:]):
            if tracker.kf_valid_host[a] and tracker.kf_valid_host[b]:
                ei.append(a)
                ej.append(b)
        # covisibility edges (>= 30 shared points, the reference's >= 100
        # scaled to this feature budget)
        for i_idx, a in enumerate(slots):
            covis = self._covis_weights(tracker, a)
            for b in slots[i_idx + 1:]:
                if covis[b] >= 30 and abs(order_of[a] - order_of[b]) > 1:
                    ei.append(a)
                    ej.append(b)
        ei_t = torch.as_tensor(ei, dtype=torch.int64, device=dev)
        ej_t = torch.as_tensor(ej, dtype=torch.int64, device=dev)
        meas = sim3.compose(verts[ej_t], sim3.inverse(verts[ei_t]))
        # loop edge: S_slot = S12 * S_cand  =>  measurement S_{slot,cand} = S12
        meas = torch.cat([meas, S12[None]])
        ei.append(cand)
        ej.append(slot)
        E = len(ei)
        weights = torch.ones(E, dtype=torch.float32, device=dev)
        weights[-1] = 5.0

        v_fixed = torch.zeros(K, dtype=torch.bool, device=dev)
        v_fixed[cand] = True
        v_valid = torch.zeros(K, dtype=torch.bool, device=dev)
        v_valid[st] = True
        prob = PoseGraphProblem(
            vertices=verts, v_fixed=v_fixed, v_valid=v_valid,
            edge_i=torch.as_tensor(ei, dtype=torch.int64, device=dev),
            edge_j=torch.as_tensor(ej, dtype=torch.int64, device=dev),
            edge_meas=meas, edge_valid=torch.ones(E, dtype=torch.bool, device=dev),
            edge_weight=weights,
        )
        new_verts, _ = optimize_essential_graph(prob, iters=20)

        # re-anchor points through their reference keyframe:
        # X' = S_new^-1 ( S_old (X) )
        ref_kf = torch.clamp(m.pt_first_kf, 0, K - 1).long()
        X_corr = sim3.apply(sim3.inverse(new_verts[ref_kf]), sim3.apply(verts[ref_kf], m.pt_pos))
        X_corr = torch.where((m.pt_valid & (m.pt_first_kf >= 0))[:, None], X_corr, m.pt_pos)
        kf_pose = torch.where(v_valid[:, None, None], sim3.to_se3(new_verts), m.kf_pose)
        tracker.map = m._replace(kf_pose=kf_pose, pt_pos=X_corr)

    def _global_ba(self, tracker, fixed_slot: int):
        """RunGlobalBundleAdjustment over every valid keyframe, with the
        full point capacity (not the windowed BA's budget), through the
        tracker's ``ba_solver`` where it has one (a mesh-parallel chunked
        tracker's distributed solver)."""
        slots = [s for s in tracker.kf_slots if tracker.kf_valid_host[s]]
        ba = run_local_ba(tracker.cam, tracker.map, slots, [fixed_slot], tracker.scale2_np,
                          max(self.cfg.capacity.local_ba_points, self.cfg.capacity.max_points),
                          solver=getattr(tracker, "ba_solver", None))
        tracker._apply_ba(ba)
