"""Map maintenance and place-recognition signatures in the port against the
reference package: ``runtime/compaction.py`` (the covisibility product,
keyframe cull and slot compaction), ``loop_closing.kf_signature``, and
``ChunkedTracker._maybe_maintain`` with everything it remaps.

Tolerances: covisibility counts, the remaps, the compacted counts and
every integer or boolean field are exact; the float fields of the
compacted map are gathers of the input, so they are exact too (asserted
to 1e-6). Signatures to 1e-6 (the vote counts are integers; only the norm
is a float32 sum in another order).

The map is fabricated in the reference's numpy layout (uint32
descriptors) and crosses to the port through ``convert.py``: keyframes see
overlapping windows of points at mostly fine octaves, so that the
redundancy rule culls some of them; one keyframe slot is invalid, one
keyframe was created by an object, and some points are already dead.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eao_slam_tpu.runtime import compaction as jcomp, loop_closing as jlc
from eao_slam_tpu.runtime.map_state import MapState as JMap
from eao_slam_torch.convert import map_state_from_numpy, map_state_to_numpy
from eao_slam_torch.runtime import compaction as tcomp, loop_closing as tlc
from torch_parity import n, random_descriptors, t

K, F, P, L = 16, 64, 512, 8


def fabricated_map(seed: int, kf_count: int = 14) -> dict:
    rng = np.random.default_rng(seed)
    d = {
        "kf_pose": np.tile(np.eye(3, 4, dtype=np.float32), (K, 1, 1)),
        "kf_valid": np.arange(K) < kf_count,
        "kf_timestamp": np.arange(K, dtype=np.float32),
        "kf_frame_id": np.arange(K, dtype=np.int32),
        "kf_kp": rng.uniform(0, 640, (K, F, 2)).astype(np.float32),
        "kf_desc": random_descriptors(rng, K * F).reshape(K, F, 8),
        "kf_octave": np.where(rng.uniform(size=(K, F)) < 0.95, 0,
                              rng.integers(0, L, (K, F))).astype(np.int32),
        "kf_angle": rng.uniform(-3, 3, (K, F)).astype(np.float32),
        "kf_kp_valid": rng.uniform(size=(K, F)) < 0.95,
        "kf_pt_idx": np.full((K, F), -1, np.int32),
        "kf_by_object": np.zeros(K, bool),
        "pt_pos": rng.normal(0, 2, (P, 3)).astype(np.float32),
        "pt_valid": np.zeros(P, bool),
        "pt_desc": random_descriptors(rng, P),
        "pt_normal": rng.normal(0, 1, (P, 3)).astype(np.float32),
        "pt_min_dist": rng.uniform(0.1, 1, P).astype(np.float32),
        "pt_max_dist": rng.uniform(2, 9, P).astype(np.float32),
        "pt_visible": rng.integers(1, 9, P).astype(np.int32),
        "pt_found": rng.integers(1, 9, P).astype(np.int32),
        "pt_first_kf": np.full(P, -1, np.int32),
        "pt_obs": rng.integers(0, 5, P).astype(np.int32),
        "pt_object_id": np.full(P, -1, np.int32),
        "pt_obj_votes": np.zeros(P, np.int32),
    }
    d["kf_valid"][5] = False               # a hole in the keyframe table
    d["kf_by_object"][8] = True             # exempt from culling
    n_pts = 10 * kf_count + 60
    d["pt_valid"][:n_pts] = rng.uniform(size=n_pts) > 0.05
    for k in range(kf_count):
        window = np.arange(10 * k, 10 * k + 60)
        take = rng.choice(window, size=F - 4 - k % 3, replace=False)
        d["kf_pt_idx"][k, :len(take)] = take
        first = d["pt_first_kf"][take]
        d["pt_first_kf"][take] = np.where(first < 0, k, first)
    return d


def _jmap(d: dict) -> JMap:
    return JMap(**{k: jnp.asarray(v) for k, v in d.items()})


def test_covisibility_counts_exact():
    d = fabricated_map(0)
    want = np.asarray(jcomp.make_covis(P)(jnp.asarray(d["kf_pt_idx"]),
                                          jnp.asarray(d["kf_kp_valid"]),
                                          jnp.asarray(d["kf_valid"])))
    m = map_state_from_numpy(d, "cpu")
    got = n(tcomp.covisibility(m.kf_pt_idx, m.kf_kp_valid, m.kf_valid, P))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert want.max() > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cull_and_compact_parity(seed):
    d = fabricated_map(seed)
    kf_count, pt_count = 14, int(d["pt_valid"].sum())
    ref = jcomp.cull_and_compact(_jmap(d), jnp.int32(kf_count), jnp.int32(pt_count),
                                 n_levels=L, redundancy=0.9)
    got = tcomp.cull_and_compact(map_state_from_numpy(d, "cpu"), kf_count, pt_count,
                                 n_levels=L, redundancy=0.9)
    if seed == 0:
        assert int(ref.n_culled_kf) > 0      # the fixture exercises the cull
    assert got.n_culled_kf == int(ref.n_culled_kf)
    assert got.kf_count == int(ref.kf_count)
    assert got.pt_count == int(ref.pt_count)
    np.testing.assert_array_equal(n(got.kf_remap), np.asarray(ref.kf_remap))
    np.testing.assert_array_equal(n(got.pt_remap), np.asarray(ref.pt_remap))
    a = map_state_to_numpy(got.m)
    for k, v in ref.m._asdict().items():
        v = np.asarray(v)
        if v.dtype.kind == "f":
            np.testing.assert_allclose(a[k], v, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(a[k], v, err_msg=k)
        assert a[k].dtype == v.dtype, k


def test_kf_signatures_parity():
    rng = np.random.default_rng(3)
    desc = random_descriptors(rng, 5 * F).reshape(5, F, 8)
    desc[1, :10] = desc[0, :10]               # repeated votes
    valid = rng.uniform(size=(5, F)) < 0.8
    valid[4] = False                          # an empty keyframe: zero signature
    got = n(tlc.kf_signatures(t(desc), t(valid)))
    for b in range(5):
        want = np.asarray(jlc.kf_signature(jnp.asarray(desc[b]), jnp.asarray(valid[b])))
        np.testing.assert_allclose(got[b], want, atol=1e-6)
        np.testing.assert_allclose(n(tlc.kf_signature(t(desc[b]), t(valid[b]))), want, atol=1e-6)
    assert not got[4].any()


def test_loop_closer_remap_slots_parity():
    """Signatures, consistency streaks and the last-loop anchor move
    through a compaction as in the reference
    (tests/test_system_chunked.py:225)."""
    from eao_slam_torch.config import CapacityConfig as TCap, tum3_config as ttum3
    from eao_slam_tpu.config import CapacityConfig as JCap, tum3_config as jtum3

    kw = dict(max_keyframes=8, max_points=512, max_features=64)
    ref = jlc.LoopCloser(jtum3().replace(capacity=JCap(**kw)))
    got = tlc.LoopCloser(ttum3().replace(capacity=TCap(**kw)))
    for lc in (ref, got):
        lc.signatures[0] = 1.0
        lc.signatures[3] = 2.0
        lc.signatures[5] = 3.0
        lc.consistent_streak = {(3, 5): 2, (2, 4): 1, (1, 3): 1}
        lc.last_loop_order = 4
        lc.remap_slots(np.array([0, 1, -1, 2, -1, 3, 4, 5]))
    np.testing.assert_array_equal(got.signatures, ref.signatures)
    assert got.consistent_streak == ref.consistent_streak == {(2, 3): 2, (1, 2): 1}
    assert got.last_loop_order == ref.last_loop_order == 2


def _reference_carry(d: dict, kf_count: int, pt_count: int, last_pt: np.ndarray):
    import jax

    from eao_slam_tpu.objects.state import empty_object_table
    from eao_slam_tpu.runtime.scan_tracker import ChunkCarry

    z = jnp.zeros
    return ChunkCarry(
        m=_jmap(d), T_last=jnp.eye(3, 4), velocity=jnp.eye(3, 4), vel_ok=jnp.asarray(False),
        last_kp=z((F, 2)), last_desc=z((F, 8), jnp.uint32), last_octave=z((F,), jnp.int32),
        last_angle=z((F,)), last_valid=jnp.ones((F,), bool),
        last_pt=jnp.asarray(last_pt), state=jnp.asarray(2, jnp.int32),
        frames_since_kf=jnp.asarray(0, jnp.int32), ref_kf_tracked=jnp.asarray(0, jnp.int32),
        peak_since_kf=jnp.asarray(0, jnp.int32), kf_count=jnp.asarray(kf_count, jnp.int32),
        pt_count=jnp.asarray(pt_count, jnp.int32), frame_id=jnp.asarray(40, jnp.int32),
        table=empty_object_table(1), obj_key=jax.random.PRNGKey(0))


def test_maybe_maintain_remaps_everything_like_the_reference():
    """The between-chunk maintenance pass on the same carry in both
    packages: the compacted carry, last_pt, last_kf_slots, the loop
    closer's state, the loop-pass cursor and the compaction listeners'
    remaps are the reference's."""
    from eao_slam_torch.config import CapacityConfig as TCap, tum3_config as ttum3
    from eao_slam_torch.convert import carry_from_numpy
    from eao_slam_torch.runtime.scan_tracker import ChunkedTracker as TTracker
    from eao_slam_tpu.config import CapacityConfig as JCap, tum3_config as jtum3
    from eao_slam_tpu.runtime.scan_tracker import ChunkedTracker as JTracker
    from torch_parity import jax_carry_numpy

    d = fabricated_map(0, kf_count=K - 2)   # within the headroom: maintenance runs
    kf_count, pt_count = K - 2, int(d["pt_valid"].sum())
    last_pt = d["kf_pt_idx"][kf_count - 1].copy()
    kw = dict(max_keyframes=K, max_points=P, max_features=F, local_ba_points=P)
    jt = JTracker(jtum3().replace(capacity=JCap(**kw)), chunk=8)
    tt = TTracker(ttum3().replace(capacity=TCap(**kw)), chunk=8, device="cpu")
    jt.carry = _reference_carry(d, kf_count, pt_count, last_pt)
    tt.carry = carry_from_numpy(jax_carry_numpy(jt.carry), "cpu")
    seen = {}
    for name, tr in (("ref", jt), ("port", tt)):
        tr.kf_count_host, tr.pt_count_host, tr.state_host = kf_count, pt_count, 2
        tr.last_kf_slots = [(3, kf_count - 2), (6, kf_count - 1), (1, 2), (2, 9)]
        tr._loop_checked = kf_count - 1
        tr.loop_closer.signatures[:kf_count] = np.arange(kf_count)[:, None] + 1.0
        tr.loop_closer.consistent_streak = {(2, 9, 10): 2}
        tr.loop_closer.last_loop_order = 10
        tr.compaction_listeners.append(lambda k, p, name=name: seen.setdefault(name, (k, p)))
        tr._maybe_maintain()
        assert tr.n_maintenance == 1
    assert tt.kf_count_host == int(jt.kf_count_host) < kf_count
    assert tt.pt_count_host == int(jt.pt_count_host)
    np.testing.assert_array_equal(seen["port"][0], seen["ref"][0])
    np.testing.assert_array_equal(seen["port"][1], seen["ref"][1])
    np.testing.assert_array_equal(n(tt.carry.last_pt), np.asarray(jt.carry.last_pt))
    assert tt.last_kf_slots == jt.last_kf_slots
    assert tt._loop_checked == jt._loop_checked
    np.testing.assert_array_equal(tt.loop_closer.signatures, jt.loop_closer.signatures)
    assert tt.loop_closer.consistent_streak == jt.loop_closer.consistent_streak
    assert tt.loop_closer.last_loop_order == jt.loop_closer.last_loop_order
    a, b = map_state_to_numpy(tt.carry.m), jax_carry_numpy(jt.carry)["m"]
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_compaction_keeps_object_membership():
    """Slot compaction moves each point's object id and votes with the
    point (and the object-created keyframe flag with its keyframe), as in
    the reference: the table of objects itself holds no slot."""
    d = fabricated_map(0)
    rng = np.random.default_rng(9)
    live = np.nonzero(d["pt_valid"])[0]
    d["pt_object_id"][live] = rng.integers(-1, 4, live.size)
    d["pt_obj_votes"][live] = np.where(d["pt_object_id"][live] >= 0,
                                       rng.integers(1, 12, live.size), 0)
    kf_count, pt_count = 14, int(d["pt_valid"].sum())
    ref = jcomp.cull_and_compact(_jmap(d), jnp.int32(kf_count), jnp.int32(pt_count),
                                 n_levels=L, redundancy=0.9)
    got = tcomp.cull_and_compact(map_state_from_numpy(d, "cpu"), kf_count, pt_count,
                                 n_levels=L, redundancy=0.9)
    a = map_state_to_numpy(got.m)
    for k in ("pt_object_id", "pt_obj_votes", "kf_by_object"):
        np.testing.assert_array_equal(a[k], np.asarray(getattr(ref.m, k)), err_msg=k)
    remap = n(got.pt_remap)
    kept = np.nonzero(remap >= 0)[0]
    assert kept.size > 0 and (d["pt_object_id"][kept] >= 0).any()
    np.testing.assert_array_equal(a["pt_object_id"][remap[kept]], d["pt_object_id"][kept])
    np.testing.assert_array_equal(a["pt_obj_votes"][remap[kept]], d["pt_obj_votes"][kept])
    kf_remap = n(got.kf_remap)
    assert kf_remap[8] >= 0 and a["kf_by_object"][kf_remap[8]]
